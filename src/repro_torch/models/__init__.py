from repro_torch.models.registry import Model, get_model  # noqa: F401
from repro_torch.models.small import SMALL_MODELS, make_loss_fn  # noqa: F401
