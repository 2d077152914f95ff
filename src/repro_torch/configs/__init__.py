from repro_torch.configs.base import FedConfig, validate_config  # noqa: F401
