"""Command-line harnesses of the port (``repro/launch``): each prints a
JSON report as its last stdout line and exits non-zero unless every check
passes.  ``W`` is the layout's worker count; the workers run in lock step
on one device (``--device``, CUDA unless ``cpu`` is asked for)."""
