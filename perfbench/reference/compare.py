"""The numbers that decide ``correct``: each a widest gap between what the
program produced and what the reference works out, as a share of a scale.

Non-finite values (the ppswor edge at u = 1.0) compare as a class: a cell
or value the reference finds non-finite must be non-finite in the program
too, and a finite one finite; a NaN estimate ranks above every number."""
from __future__ import annotations

import torch

NEG = -torch.inf


def finite_scale(x: torch.Tensor) -> torch.Tensor:
    """Per row, the largest finite |value| (1 where a row has none)."""
    a = x.abs().to(torch.float64)
    a = torch.where(torch.isfinite(a), a, 0.0).amax(-1)
    return torch.where(a > 0, a, torch.ones_like(a))


def table_err(got: torch.Tensor, want: torch.Tensor,
              absum: torch.Tensor) -> float:
    """max |got - want| / sum |terms| over the finite cells of ``want``;
    inf where the two disagree on which cells are finite, or where a cell
    that received nothing is not zero."""
    got = got.to(torch.float64)
    fin_w, fin_g = torch.isfinite(want), torch.isfinite(got)
    if bool((fin_w != fin_g).any()):
        return float("inf")
    diff = torch.where(fin_w, (got - want).abs(), 0.0)
    empty = absum == 0
    if bool((empty & (diff > 0)).any()):
        return float("inf")
    return float(torch.where(empty, 0.0, diff / torch.where(
        empty, 1.0, absum)).max())


def lookup(keys: torch.Tensor, pool: torch.Tensor,
           pool_prio: torch.Tensor) -> torch.Tensor:
    """The priority of each of the program's (B, c) keys in its stream's
    pool (sorted ascending, -1 past its keys): -inf for -1, for a repeat
    of a key already kept, and for a key that is not in the pool."""
    big = torch.iinfo(torch.int64).max
    ps = torch.where(pool == -1, big, pool)
    k = keys.to(torch.int64)
    idx = torch.searchsorted(ps, k).clamp(max=ps.shape[1] - 1)
    found = (torch.gather(ps, 1, idx) == k) & (k != -1)
    prio = torch.where(found, torch.gather(pool_prio, 1, idx), NEG)
    return torch.where(repeats(k), NEG, prio)


def repeats(keys: torch.Tensor) -> torch.Tensor:
    """True at every slot whose key an earlier slot of the row holds."""
    order = torch.sort(keys, dim=1, stable=True)
    s = order.values
    rep = torch.zeros_like(s, dtype=torch.bool)
    rep[:, 1:] = (s[:, 1:] == s[:, :-1]) & (s[:, 1:] != -1)
    return torch.zeros_like(rep).scatter(1, order.indices, rep)


def rank_gap(ref_top: torch.Tensor, got_prio: torch.Tensor,
             scale: torch.Tensor) -> float:
    """Widest shortfall, rank by rank, of the program's kept keys' reference
    priorities below the reference's own best (both descending), as a
    share of each row's ``scale``: 0 where the program kept the best keys,
    inf where it kept a key it should not have (-inf) in a best key's
    place."""
    got = torch.sort(got_prio, dim=1, descending=True).values
    c = ref_top.shape[1]
    if got.shape[1] < c:
        got = torch.cat([got, torch.full(
            (got.shape[0], c - got.shape[1]), NEG, dtype=got.dtype,
            device=got.device)], 1)
    diff = ref_top - got[:, :c]
    diff = torch.where(torch.isnan(diff), 0.0, diff).clamp(min=0)
    return float((diff / scale[:, None]).max())


def value_err(got: torch.Tensor, want: torch.Tensor,
              scale: torch.Tensor) -> float:
    """max |got - want| / the row's scale; inf where one of the two is
    finite and the other not."""
    got = got.to(torch.float64)
    want = want.to(torch.float64)
    fin_w, fin_g = torch.isfinite(want), torch.isfinite(got)
    if bool((fin_w != fin_g).any()):
        return float("inf")
    diff = torch.where(fin_w, (got - want).abs(), 0.0)
    return float((diff / scale.reshape(-1, *([1] * (diff.dim() - 1)))).max())
