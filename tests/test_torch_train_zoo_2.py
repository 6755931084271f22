"""The zoo's training path in the port (``train/train_step.py``,
``train/optimizer.py``, ``models/`` with gradients) against the JAX
reference on the CPU, for the next three of the ten archs in name order at smoke
size: ``loss_fn``, every gradient leaf, the chunked CE and one
``make_train_step`` step with and without remat.  The cases and their
tolerances are in ``tests/torch_train_cases.py``; the archs are split
over ``test_torch_train_zoo.py``, ``_zoo_2.py`` and ``_zoo_3.py`` so that
no file runs long."""
from repro import configs as ref_configs
from torch_train_cases import make_tests

NAMES = sorted(ref_configs.ARCHS)[3:6]

(test_loss_fn_matches_reference, test_grads_match_reference,
 test_chunked_ce_matches_reference,
 test_train_step_matches_reference) = make_tests(NAMES)
