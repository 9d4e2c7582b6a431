"""Multi-worker serving analytics: N engine shards aggregated through the
merge trees (PyTorch).

The port's counterpart of ``repro.launch.serve``'s ``make_worker_engines``,
``aggregate_worker_states`` and ``sample_aggregated``.  The decode stream
is sharded round-robin across N ``SketchEngine`` workers of one config:
identical configs derive identical per-stream seeds, so stream b of every
worker is a shard of request b's logical stream, and at sampling time the
workers' states reduce through ``sharding.merge_states`` (the host
butterfly for power-of-two counts, the pairwise tree otherwise) with the
engine's batched merge.  The aggregated samples equal a single worker that
saw the whole stream.  The CLI (model prefill and decode) comes with the
port's models.
"""
from __future__ import annotations

from repro_torch.distributed import sharding as shd
from repro_torch.engine import EngineConfig, SketchEngine


def make_worker_engines(cfg: EngineConfig, workers: int, plane: str = "sparse",
                        flush_elems: int = 4096, plane_opts: dict = None,
                        device=None) -> list:
    """N mergeable engine shards: identical EngineConfig => identical
    per-stream hash/transform seeds (the ``merge_with`` contract), on
    ``device`` (the card unless the caller asks otherwise).  ``plane_opts``
    forwards plane-specific options."""
    if workers < 1:
        raise ValueError(f"workers must be >= 1, got {workers}")
    return [SketchEngine(cfg, plane=plane, flush_elems=flush_elems,
                         plane_opts=plane_opts, device=device)
            for _ in range(workers)]


def aggregate_worker_states(workers: list, codec: str = "none"):
    """Drain every worker's data plane and reduce the shard states to the
    union state through ``sharding.merge_states``.  ``codec`` names the
    wire codec each worker's state crosses to the aggregator (``none``
    keeps the bitwise path)."""
    if not workers:
        raise ValueError("aggregate_worker_states of no workers")
    ref = workers[0].cfg
    for i, w in enumerate(workers[1:], start=1):
        if w.cfg != ref:
            raise ValueError(
                f"worker {i} config differs from worker 0; shards must "
                f"share an EngineConfig to be mergeable")
    states = [w.flush().state for w in workers]
    return shd.merge_states(states, workers[0].merge_fn, codec=codec)


def sample_aggregated(workers: list, k: int, codec: str = "none"):
    """Per-request WOR samples over the UNION of all workers' ingested
    traffic (equals a single worker that saw the whole stream)."""
    merged = aggregate_worker_states(workers, codec=codec)
    return workers[0].sample_state(merged, k)
