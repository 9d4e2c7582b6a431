"""The deterministic kernels' split of a table too large for one block, on
the CPU (``repro_torch.kernels.tiling``).

Under ``torch.use_deterministic_algorithms(True)`` the scatter (#1) and the
dense update (#3/#4) take their "det" variants, whose blocks each hold a
stream's (or a chunk's) whole rows x width table in shared memory.  A
table too large for that is spread over a thread block cluster of at most
8 CTAs (``tiling.det_cluster``): each CTA a row group, or, where one row a
CTA does not fit, a bucket range of each row, small enough that two CTAs
fit an SM; the cluster hashes each slot once.  Past what a cluster holds,
the table is split across blocks that each hash every slot
(``tiling.det_split``: row groups of as many rows as fit, or equal bucket
ranges of each row).  The order model fixes a cell's terms only within
its row and every lead of a bucket falls in one range, so either keeps the
order models' bits (``ref.countsketch_scatter_det_ref`` and
``ref.countsketch_update_det_ref``, which the card tests hold the split
kernels to).  Here: the plans that one block held stay as they were, tuple
for tuple; a split plan owns every (stream or chunk, row, bucket) cell
with exactly one CTA or block, each within a block's 232,448 B and a
cluster's CTAs two an SM; the chunk of the dense update stays the whole
table's; shapes past the kernels' index or grid limits raise, naming the
shape.  No card, no JAX: plain arithmetic.
"""
import numpy as np
import pytest

from repro_torch.kernels import tiling

SMEM = tiling.SMEM_PER_BLOCK_OPTIN
# (rows, width): just past the dense det's widest rows-7 table; the table
# of ``fleet_serve --topk 528`` (7 x 16,384 at the flush); ``fleet_serve
# --topk 400``'s 5 x 12,400; one row of 100,000 buckets (bucket ranges);
# two rows of 60,000 (two rows of four ranges); past what a cluster holds:
# 7 x 100,000 (blocks of bucket ranges) and 17 x 16,384 (blocks of row
# groups)
SPLIT_SHAPES = [(7, 8_046), (7, 16_384), (5, 12_400), (1, 100_000),
                (2, 60_000), (7, 100_000), (17, 16_384)]
# the shapes a cluster holds: every one of the dense update's that fits;
# the scatter's only row groups of three CTAs an SM (its other clusters
# were slower on the card than the blocks)
CLUSTERED = {"update": {(7, 8_046), (7, 16_384), (5, 12_400), (1, 100_000),
                        (2, 60_000)},
             "scatter": {(7, 8_046), (5, 12_400)}}
LENGTHS = np.array([5_000, 0, 123_457, 1, 4_096])
# two CTAs of a cluster, each with the card's reserve, in an SM's 228 KB
TWO_AN_SM = tiling.SMEM_PER_SM // 2 - tiling.SMEM_RESERVED_PER_BLOCK


def _plan(kernel, rows, width, lengths=LENGTHS, B=None, n=None):
    B = len(lengths) if B is None else B
    n = int(np.max(lengths)) if n is None else n
    return tiling.table_plan(B, n, lengths, rows, width, 132,
                             deterministic=True,
                             det_chunks=kernel == "update")


def _smem(kernel):
    return tiling.det_dense_smem_bytes if kernel == "update" \
        else tiling.det_smem_bytes


def _part_smem(plan, kernel, rows, width):
    """Shared memory of a part of ``srows`` rows of ``span`` buckets: a
    cluster CTA's (its slice and stages of every row) or a block's."""
    if plan.cluster:
        return lambda srows, span: tiling.det_cluster_smem_bytes(
            plan.cluster, srows, span)
    return _smem(kernel)


@pytest.mark.parametrize("kernel", ["scatter", "update"])
@pytest.mark.parametrize("rows,width", SPLIT_SHAPES)
def test_split_plan_owns_every_cell_once(rows, width, kernel):
    """Each stream (scatter) or chunk (dense update) of a split plan is
    cut into parts whose CTAs (a cluster's, ``det_cluster``) or blocks
    (``det_split``, past what a cluster holds) own its rows x width cells
    exactly once, each within a block's shared memory; the chunks tile
    every stream's live slots; a cluster CTA's threads are 8 producer
    warps and a walker a row, a block's a row group's."""
    plan = _plan(kernel, rows, width)
    group, ranges = tiling.det_cluster(rows, width, kernel == "scatter")
    assert bool(group) is ((rows, width) in CLUSTERED[kernel])
    if not group:
        group, ranges = tiling.det_split(rows, width, _smem(kernel))
    assert (plan.variant, plan.row_group, plan.ranges) == ("det", group,
                                                          ranges)
    assert group and plan.smem_bytes <= SMEM
    parts = tiling.det_parts(plan, rows)
    threads = tiling.det_dense_threads if kernel == "update" \
        else tiling.det_threads
    if plan.cluster:
        assert plan.cluster == parts and plan.threads == tiling.det_threads(
            group) == 32 * (8 + min(group, 8))
    else:
        assert plan.threads == threads(group)
    blocks = tiling.det_plan_blocks(plan, LENGTHS, rows, width)
    assert blocks.shape == (plan.blocks, 7) and plan.blocks % parts == 0
    owned = {}
    smem = _part_smem(plan, kernel, rows, width)
    for b, s0, s1, r0, r1, w0, w1 in blocks.tolist():
        assert 0 <= r0 < r1 <= rows and 0 <= w0 < w1 <= width
        assert smem(r1 - r0, w1 - w0) <= plan.smem_bytes
        cells = owned.setdefault((b, s0, s1), np.zeros((rows, width),
                                                       np.int64))
        cells[r0:r1, w0:w1] += 1
    assert all((c == 1).all() for c in owned.values())
    for b, length in enumerate(LENGTHS):
        spans = sorted((s0, s1) for sb, s0, s1 in owned if sb == b)
        if plan.one_per_stream:
            assert spans == [(0, int(length))]
        elif not length:  # an empty stream's chunks get no block
            assert spans == []
        else:  # the chunks hold the live slots, in order, once
            assert spans[0][0] == 0 and spans[-1][1] == length
            assert all(a[1] == c[0] for a, c in zip(spans, spans[1:]))


@pytest.mark.parametrize("kernel", ["scatter", "update"])
@pytest.mark.parametrize("rows,width", SPLIT_SHAPES)
def test_split_parts_are_as_large_as_fit(rows, width, kernel):
    """A cluster (the parts' CTAs, at most ``DET_MAX_CLUSTER`` = 8) takes
    row groups of the fewest rows that keep it within 8 CTAs, or, where
    one row a CTA does not fit, 8 // rows bucket ranges of each row (the
    dense update's only); each CTA's slice and inbox fit twice in an SM's
    228 KB (the scatter's three times), with the card's 1 KB reserve a
    block, and its inbox holds buckets of its own slice (16 bits up to
    2**16).  Past what a cluster holds, row groups
    of blocks take the most rows that fit a block (one more does not
    fit); bucket ranges only where one row does not, as few as fit; the
    16-bit staged entry of the scatter wherever a range spans at most
    2**15 buckets."""
    smem = _smem(kernel)
    plan = _plan(kernel, rows, width)
    assert smem(rows, width) > SMEM
    if plan.cluster:
        span, parts = tiling.det_span(plan, width), plan.cluster
        assert 2 <= parts <= tiling.DET_MAX_CLUSTER == 8
        assert plan.smem_bytes == tiling.det_cluster_smem_bytes(
            parts, plan.row_group, span, tiling.det_clash_bits(
                plan, width)) <= TWO_AN_SM
        assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024
        if plan.ranges == 1:
            assert plan.row_group == -(-rows // 8)
        else:
            assert plan.row_group == 1 and plan.ranges == 8 // rows
            assert tiling.det_cluster_smem_bytes(rows, 1, width) > TWO_AN_SM
        # the inbox: for each of the slice's rows and every CTA's 256 slots
        # a live mask a group, a term and a bucket of its own a slot; the
        # producer warps' clash bitmaps, as large as keep the CTAs an SM
        bucket = 2 if span <= 2**16 else 4
        bits = tiling.det_clash_bits(plan, width)
        assert 1024 <= bits <= 16_384 and bits & (bits - 1) == 0
        assert plan.smem_bytes == plan.row_group * span * 4 + 2 * parts \
            * plan.row_group * (8 * 4 + 256 * 4 + 256 * bucket) \
            + 8 * bits // 8
        least = tiling.det_cluster_smem_bytes(parts, plan.row_group, span)
        per_sm = (228 * 1024) // (least + 1024)
        if kernel == "scatter":
            assert plan.ranges == 1 and per_sm >= 3
        assert (228 * 1024) // (plan.smem_bytes + 1024) == per_sm
        if bits < 16_384 and bits < width:
            assert (228 * 1024) // (tiling.det_cluster_smem_bytes(
                parts, plan.row_group, span, 2 * bits) + 1024) < per_sm
        return
    if plan.ranges == 1:
        assert smem(plan.row_group, width) <= SMEM \
            < smem(plan.row_group + 1, width)
        assert tiling.det_span(plan, width) == width
    else:
        assert plan.row_group == 1 and smem(1, width) > SMEM
        span = tiling.det_span(plan, width)
        assert span == -(-width // plan.ranges)
        assert smem(1, span) <= SMEM < smem(1, -(-width // (plan.ranges
                                                            - 1)))
        if kernel == "scatter":
            assert tiling.det_entry_bytes(span) == (2 if span <= 2**15
                                                    else 4)


@pytest.mark.parametrize("kernel", ["scatter", "update"])
def test_split_keeps_the_whole_tables_chunk(kernel):
    """The dense update's chunk is a function of the whole table's shape,
    split or not, over a cluster or over blocks (so ``ref.
    countsketch_update_det_ref(..., chunk=plan.chunk)`` stays the kernel's
    order); the scatter's is its stage: at the flush's 4096 streams a
    cluster of five one-row CTAs a stream at 5 x 12,400, three row-group
    blocks at 7 x 16,384.  One 21.2 M segment at 7 x 16,384 is 132 chunks
    of 161,280 slots (its live slots over the SMs, under four tables'
    cells), a cluster of 7 one-row CTAs each; at 1 x 100,000 the same 132
    chunks of 160,896, a cluster of 8 bucket-range CTAs each."""
    if kernel == "scatter":
        plan = _plan(kernel, 7, 16_384, None, B=4096, n=5120)
        assert plan == tiling.TablePlan("det", 3 * 4096, 32 * (8 + 3),
                                        tiling.DET_STAGE, True,
                                        tiling.det_smem_bytes(3, 16_384),
                                        3, 1)
        plan = _plan(kernel, 5, 12_400, None, B=4096, n=5120)
        assert plan == tiling.TablePlan(
            "det", 5 * 4096, 32 * (8 + 1), tiling.DET_STAGE, True,
            tiling.det_cluster_smem_bytes(5, 1, 12_400, 8_192), 1, 1, 5)
        # 8,192-bit bitmaps: 16,384 would leave two CTAs an SM, not three
        assert plan.smem_bytes == 12_400 * 4 + 2 * 5 * (
            8 * 4 + 256 * 4 + 256 * 2) + 8 * 8_192 // 8 == 73_472
        return
    n = 2304 * 9216
    for rows, width, chunk, parts in ((7, 16_384, 161_280, 7),
                                      (1, 100_000, 160_896, 8)):
        plan = _plan(kernel, rows, width, np.array([n]))
        whole = tiling._chunked_plan(
            "det", 1, np.array([n]), rows, width, 132,
            tiling.det_dense_threads(rows),
            tiling.det_dense_smem_bytes(rows, width),
            tiling.DET_DENSE_BLOCKS_PER_SM, tiling.det_dense_stage(rows))
        assert plan.chunk == whole.chunk == chunk == tiling.pad_to(
            -(-n // 132), tiling.det_dense_stage(rows))
        assert plan.blocks == parts * int(tiling.block_ends(
            np.array([n]), plan.chunk)[-1]) == parts * 132
        assert (plan.threads, plan.row_group, plan.cluster) == (288, 1,
                                                                parts)


# plans of tables one block holds: those of the parent, tuple for tuple
# (variant, blocks, threads, chunk, one_per_stream, smem_bytes)
_D, _FF = 2304, 9216
_LAYER = np.array([_D] * 4 + [_D * _FF] * 2 + [_D * 4 * 256, 8 * 256 * _D,
                                               _FF * _D, _D * 8 * 256,
                                               _D * 4 * 256])
NARROW = {
    "scatter flush": (("scatter", 7, 2048, None, 4096, 5120),
                      ("det", 4096, 480, 256, True, 66_624)),
    "scatter widest rows 7": (("scatter", 7, 7_970, None, 8, 100),
                              ("det", 8, 480, 256, True, 232_440)),
    "scatter widest rows 1": (("scatter", 1, 57_072, None, 8, 100),
                              ("det", 8, 288, 256, True, 232_448)),
    "update gemma2_2b layer": (("update", 7, 2048, _LAYER, None, None),
                               ("det", 1183, 224, 66_304, False, 64_512)),
    "update one segment": (("update", 7, 2048, np.array([_D * _FF]), None,
                            None), ("det", 371, 224, 57_344, False, 64_512)),
    "update widest rows 7": (("update", 7, 8_045, np.array([300_000, 5]),
                              None, None),
                             ("det", 113, 224, 2_688, False, 232_428)),
    "update widest rows 1": (("update", 1, 57_856, np.array([300_000, 5]),
                              None, None),
                             ("det", 132, 32, 2_304, False, 232_448)),
}


@pytest.mark.parametrize("case", sorted(NARROW))
def test_plans_one_block_holds_are_unchanged(case):
    """A table that one block holds keeps its plan: the same variant,
    blocks, threads, chunk and shared memory as before the split existed,
    and no split (``row_group`` 0, ``ranges`` 1, ``cluster`` 0)."""
    (kernel, rows, width, lens, B, n), want = NARROW[case]
    plan = _plan(kernel, rows, width, lens, B, n) if lens is not None \
        else tiling.table_plan(B, n, None, rows, width, 132,
                               deterministic=True)
    assert tuple(plan) == (*want, 0, 1, 0)
    assert plan == tiling.TablePlan(*want)
    assert tiling.det_parts(plan, rows) == 1
    fits = tiling.det_dense_fits if kernel == "update" else tiling.det_fits
    assert fits(rows, width)


@pytest.mark.parametrize("kernel", ["scatter", "update"])
def test_split_beyond_the_limits_raises_naming_the_shape(kernel):
    """A table past the kernels' 32-bit cell index raises and names the
    shape, as does a scatter split past the grid limit, over a cluster
    (5 x 12,400: 5 CTAs a stream) or over blocks (7 x 16,384: 3 row
    groups; 7 x 100,000: 14 bucket ranges); its B streams are not read,
    so 2**30 of them cost nothing here."""
    with pytest.raises(ValueError, match="2 x 1073741825"):
        _plan(kernel, 2, 2**30 + 1, np.array([10, 3]))
    if kernel == "scatter":
        for rows, width, parts in ((5, 12_400, 5), (7, 16_384, 3),
                                   (7, 100_000, 14)):
            with pytest.raises(ValueError, match=f"{rows} x {width} .*split "
                                                 f"{parts} ways.*grid limit"):
                tiling.table_plan(2**30, 10, None, rows, width, 132,
                                  deterministic=True)
