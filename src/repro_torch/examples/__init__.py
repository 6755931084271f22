"""Twins of the examples (``examples/*.py``): the LDA ones and
``serve_lm``, run with
``python -m repro_torch.examples.<name>``: the reference scripts'
arguments and defaults plus ``--device`` (CUDA unless ``cpu`` is asked
for), the W workers of a ring in lock step on one device."""
