"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes wrappers,
and the plain PyTorch versions they are held against (``ref``)."""


def launch_counts() -> dict:
    """This process's kernel launches, from the wrappers' counters: the
    batched scatter (all, and by variant), the segment sum, the estimate,
    the batched row read, and every other kernel's launches summed (the
    single-stream scatter's among them)."""
    from . import countsketch_query as q
    from . import countsketch_scatter as s
    from . import countsketch_update as u
    from . import ppswor_transform as tr
    from . import segment_sum as sg

    return {"scatter": s.launches, "smem": s.variant_launches["smem"],
            "global": s.variant_launches["global"],
            "det": s.variant_launches["det"], "segment_sum": sg.launches,
            "estimate": q.estimate_launches, "row_read": q.launches,
            "other": (s.single_launches + q.single_launches
                      + q.estimate_single_launches + u.launches
                      + u.single_launches + tr.launches)}
