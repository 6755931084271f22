"""Roofline of the dry-run (``repro/roofline``): per-device counts of a
step (``hlo_cost``) and the terms over the H100's rates (``analysis``)."""
from repro_torch.roofline.analysis import (  # noqa: F401
    model_flops, roofline_terms, load_reports, build_table)
