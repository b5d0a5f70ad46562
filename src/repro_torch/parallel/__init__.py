from repro_torch.parallel.sharding import (  # noqa: F401
    batch_spec,
    make_shardings,
    shard_hint,
)
