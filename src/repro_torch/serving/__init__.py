from repro_torch.serving.scheduler import BatchScheduler, Request  # noqa: F401
