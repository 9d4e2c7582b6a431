"""The in-process serving fleet: the ``fleet`` data plane (PyTorch).

The port's counterpart of ``repro.distributed.fleet``'s ``FleetPlane`` and
``reference_sample``: the single-process model of the fleet's data path,
and the conformance grid's ``fleet`` path.  The multi-process coordinator
(replica processes, fault plans, recovery) comes with a later slice.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import weakref
from typing import Optional

from repro_torch.distributed import sharding as shd
from repro_torch.engine import planes
from repro_torch.train import checkpoint


@planes.register_plane("fleet")
class FleetPlane(planes.PipelinePlane):
    """The pipeline's router (``partition_by_key`` across ``replicas``
    sub-planes, each dispatching per forwarded block), but every collapse
    runs the merge protocol: each replica state is published through a
    ``train.checkpoint`` save/restore round-trip (atomic commit, per-leaf
    CRC32) into a scratch directory, then reduced with
    ``sharding.merge_states`` under the seed guards.  At R = 2 the
    collapse equals the pipeline's bit for bit (the round-trip is an
    identity under ``none``; the butterfly of two is the pipeline's fold).
    """

    def __init__(self, spec, state, policy=None, replicas: int = 2,
                 subplane: str = "sparse", codec: str = "none"):
        if subplane == "fleet":
            raise ValueError("fleet sub-planes cannot nest")
        super().__init__(spec, state, policy=policy, shards=replicas,
                         subplane=subplane, codec=codec)
        self.replicas = self.shards
        self._scratch: Optional[str] = None

    def _scratch_dir(self) -> str:
        if self._scratch is None:
            self._scratch = tempfile.mkdtemp(prefix="repro-torch-fleet-")
            weakref.finalize(self, shutil.rmtree, self._scratch,
                             ignore_errors=True)
        return self._scratch

    def _publish_roundtrip(self, shard: int, st):
        """One replica publish: commit + CRC-verified restore onto the
        plane's device (step 0 is overwritten per collapse, so scratch
        usage stays bounded).  With a lossy codec the commit stores the
        ENCODED leaves, so this crossing is the wire."""
        d = os.path.join(self._scratch_dir(), f"replica_{shard:02d}")
        checkpoint.save(d, 0, st, codec=self.codec)
        return checkpoint.restore(d, 0, st, device=self.device)

    @property
    def state(self):
        """The collapsed state via the checkpoint merge protocol."""
        self._settle()
        if self._merged is None:
            published = [self._publish_roundtrip(i, sub.state)
                         for i, sub in enumerate(self._subplanes)]
            # no codec here: the publish round-trip above IS the wire
            # crossing; a second application would quantize twice
            self._merged = shd.merge_states(published, self._merge)
        return self._merged

    def close(self):
        super().close()
        if self._scratch is not None:
            shutil.rmtree(self._scratch, ignore_errors=True)
            self._scratch = None


def reference_sample(ecfg, batches, replicas: int, k: int,
                     subplane: str = "sparse", codec: str = "none",
                     device=None):
    """Single-process reference for a fleet run: feed the microbatch stream
    through the ``fleet`` plane (identical routing, dispatch granularity
    and merge protocol, the wire codec included) and sample once."""
    from repro_torch.engine.engine import SketchEngine

    eng = SketchEngine(ecfg, flush_elems=1, plane="fleet", device=device,
                       plane_opts={"replicas": replicas,
                                   "subplane": subplane, "codec": codec})
    try:
        for keys, vals in batches:
            eng.ingest(keys, vals)
        return eng.sample(k)
    finally:
        eng.plane.close()


__all__ = ["FleetPlane", "reference_sample"]
