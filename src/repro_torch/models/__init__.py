from repro_torch.models.small import SMALL_MODELS, make_loss_fn  # noqa: F401
