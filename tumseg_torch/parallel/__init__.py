from tumseg_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    Mesh,
    initialize_distributed,
    make_mesh,
    pad_to_multiple,
    pmean,
    psum,
    shard_batch,
    spawn,
)
