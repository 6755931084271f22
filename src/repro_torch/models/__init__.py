"""The model zoo (``repro/models``): configs, layers and the transformer
of the ten assigned archs, in plain PyTorch."""
from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.transformer import init_params, forward  # noqa: F401
