"""SketchEngine: B sampler streams as one batched state, with the turnstile
data planes (``planes``)."""
from .engine import (  # noqa: F401
    EngineConfig,
    SketchEngine,
    derive_stream_seeds,
    engine_spec,
    onepass_init_batched,
    onepass_merge_batched,
    onepass_sample_batched,
    onepass_update_dense,
    reduce_streams,
    sampler_config,
)
from .planes import (  # noqa: F401
    DataPlane,
    DensePlane,
    FlushPolicy,
    SparsePlane,
    available_planes,
    ingest_sparse,
    make_plane,
    onepass_update_sparse,
    register_plane,
    register_sparse_path,
)
