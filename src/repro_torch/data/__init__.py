"""The port's own copies of ``repro.data``'s numpy federations (SYNTH and
the uniclass-shard benchmark stand-ins). Same seed, byte-identical data."""
from repro_torch.data.synth import Federation, make_synth_federation  # noqa: F401
from repro_torch.data.shards import make_benchmark_federation  # noqa: F401
