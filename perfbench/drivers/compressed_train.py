"""``compressed_train``: the port's WORp-compressed data-parallel training
step through the engine compressor
(``train.steps.make_compressed_train_step_engine``) over a one-rank
``torch.distributed`` group (NCCL on the card, gloo on the CPU; its file
store under ``TMPDIR``), a step a cycle, the parameters, the AdamW state
and the error feedback carried from step to step.

The model is the configuration's (Hugging Face keys, ``program_arch``
naming the program's architecture, cut as the file says); a run on the CPU
takes the file's ``rehearsal`` widths instead (the harness's tests: the
benchmark runs on the card only).  Its weights are drawn from the seed:
the program's ``init_params``, then every matrix (the embedding, the
projections, the router, the experts; not the depthwise conv) drawn again
from a normal of the file's ``initializer_range``, as Hugging Face
initialises the model.  Traffic parameters: ``batch``, ``seq``,
``zipf`` (the token ids' Zipf exponent over the vocabulary slice),
``pool`` (distinct batches, drawn on the device from the seed and
replayed in turn), ``k_per_leaf``, ``cand_per_leaf``, ``lr``,
``warm_steps``, ``trace_cycles``, ``checked``.

Checked, on the first step (of set-up) and on a step sampled from the
window, each on what that step computed: the compression
(``reference.gradcomp.check``: ``ids_gap``, ``cand_gap``, ``value_err``,
``error_err``, ``comm_bytes_err``) of the step's own gradients and the
error it carried in, against the sparse update the step applied and its
communicated bytes (the sampled step's new error is the one number taken
from a re-run: the program compresses that step's kept inputs again after
the window, since a copy of the error would not fit beside the state);
``update_err``, the AdamW update from the same sparse update at a seeded
sample of every leaf's coordinates (and, on the first step, at its
update's coordinates): the moments' relative error, and a parameter's
bfloat16 ulps past one; ``moe_dropped``, the choices the expert layers
dropped.  ``loss_err`` (the loss's relative error) and ``grad_err`` (the
worst leaf's relative L2 error) hold the step's loss and gradients to the
reference's float32 ones (``reference/granite_hybrid.py``, computed layer
by layer, one sequence at a time, after the program's state is freed) at
the parameters and batch the step saw.
"""
from __future__ import annotations

import dataclasses
import math
import os
import shutil
import tempfile
from collections.abc import Mapping

import torch
from torch.profiler import record_function

from perfbench import flops, traffic_gen
from perfbench.drivers import Base
from perfbench.reference import adamw as ref_adamw
from perfbench.reference import gradcomp, hashing
from perfbench.reference.granite_hybrid import Reference

SUBSET = 4096  # coordinates of a leaf whose AdamW update is checked


def flat(tree, pre: str = "") -> dict:
    """A nested dict's leaves by dotted name (sorted names are the
    program's leaf order)."""
    if not isinstance(tree, dict):
        return {pre: tree}
    out = {}
    for k in sorted(tree):
        out.update(flat(tree[k], f"{pre}.{k}" if pre else k))
    return out


class Lazy(Mapping):
    """A mapping whose values are made when read (one leaf at a time on
    the device)."""

    def __init__(self, names, make):
        self.names, self.make = list(names), make

    def __getitem__(self, name):
        return self.make(name)

    def __iter__(self):
        return iter(self.names)

    def __len__(self):
        return len(self.names)


def hf_config(config: dict, cpu: bool) -> dict:
    """The configuration's Hugging Face keys, the rehearsal's widths over
    them on the CPU."""
    hf = {k: v for k, v in config.items() if k != "rehearsal"}
    if cpu:
        hf.update({k: v for k, v in config["rehearsal"].items()
                   if k != "about"})
    return hf


def program_config(base, hf: dict):
    """The program's ``ArchConfig`` of the cut: ``base`` (the
    architecture's published config) with every width and count the keys
    give."""
    D = hf["hidden_size"]
    di = hf["mamba_n_heads"] * hf["mamba_d_head"]
    if di % D or hf["position_embedding_type"] != "nope":
        raise ValueError("the program's hybrid_moe family takes a Mamba "
                         "width a multiple of the hidden size and NoPE")
    return dataclasses.replace(
        base, num_layers=hf["num_hidden_layers"], d_model=D,
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf["num_key_value_heads"],
        head_dim=D // hf["num_attention_heads"],
        vocab_size=hf["vocab_size"], num_experts=hf["num_experts_total"],
        experts_held=hf["num_local_experts"],
        expert_offset=hf["expert_offset"],
        moe_top_k=hf["num_experts_per_tok"],
        d_ff_expert=hf["intermediate_size"],
        shared_d_ff=hf["shared_intermediate_size"],
        ssm_state=hf["mamba_d_state"], ssm_expand=di // D,
        ssm_headdim=hf["mamba_d_head"], ssm_conv=hf["mamba_d_conv"],
        ssm_groups=hf["mamba_n_groups"],
        ssm_conv_bias=bool(hf["mamba_conv_bias"]),
        layer_types=tuple(hf["layer_types"]),
        attn_scale=hf["attention_multiplier"],
        embedding_multiplier=hf["embedding_multiplier"],
        residual_multiplier=hf["residual_multiplier"],
        logits_scaling=hf["logits_scaling"], norm_eps=hf["rms_norm_eps"],
        tied_embeddings=bool(hf["tie_word_embeddings"]))


def reference_grads(ref: Reference, params: dict, tokens, labels,
                    dtype=torch.float32):
    """The reference's loss and gradients (summed in ``dtype``) of every
    leaf of the program's parameter tree (flat names), one sequence at a
    time, layer by layer: a forward without autograd keeps each layer's
    input, then each layer, its parameters taken in float32, is run again
    with autograd and differentiated from the top down.  The same sums as
    one autograd pass through the whole model, in the memory of one
    layer."""
    with torch.enable_grad():
        return _reference_grads(ref, flat(params), tokens, labels, dtype)


def _reference_grads(ref: Reference, named: dict, tokens, labels, dtype):
    def f32(t, grad=False):
        return t.detach().to(torch.float32).requires_grad_(grad)

    out = {k: torch.zeros(v.shape, dtype=dtype, device=v.device)
           for k, v in named.items()}
    top = {k: f32(named[k], True) for k in ("embed", "final_norm")}
    seen = {"mamba": 0, "attention": 0}
    layers = []  # (kind, stack, index in the stack)
    for kind in ref.c["layer_types"][:ref.c["num_hidden_layers"]]:
        layers.append((kind, "mamba" if kind == "mamba" else "attn",
                       seen[kind]))
        seen[kind] += 1

    def layer_params(stack, j, grad):
        return {k[len(stack) + 1:]: f32(v[j], grad) for k, v in named.items()
                if k.startswith(stack + ".")}

    total = labels.numel()
    loss = 0.0
    for b in range(tokens.shape[0]):
        tok, lab = tokens[b:b + 1], labels[b:b + 1]
        with torch.no_grad():
            xs = [ref.embed(top, tok)]
            for kind, stack, j in layers:
                p = _unflat(layer_params(stack, j, False))
                xs.append(ref.layer(xs[-1], p, kind))
        x = xs.pop().requires_grad_(True)
        part = ref.head_loss(top, x, lab, reduction="sum") / total
        part.backward()
        loss += float(part.detach())
        gx = x.grad
        for kind, stack, j in reversed(layers):
            xi = xs.pop().requires_grad_(True)
            p = layer_params(stack, j, True)
            got = torch.autograd.grad(ref.layer(xi, _unflat(p), kind),
                                      [xi, *p.values()], gx)
            gx = got[0]
            for k, g in zip(p, got[1:]):
                out[f"{stack}.{k}"][j] += g.to(dtype)
        ref.embed(top, tok).backward(gx)
    for k, v in top.items():
        out[k] += v.grad.to(dtype)
    return loss, out


def _unflat(named: dict) -> dict:
    out: dict = {}
    for name, v in named.items():
        node = out
        *path, last = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return out


class Driver(Base):
    def setup(self):
        from repro_torch.configs.base import get_config
        from repro_torch.models import model as M
        from repro_torch.optim import adamw
        from repro_torch.optim import gradcomp as program_gradcomp
        from repro_torch.train import steps

        cfg, tr = self.config, self.traffic
        cpu = self.device.type == "cpu"
        if not cpu:  # the state fills the card: segments that grow in place
            torch.cuda.memory._set_allocator_settings(
                "expandable_segments:True")
        self.hf = hf_config(cfg, cpu)
        self.arch = program_config(get_config(cfg["program_arch"]), self.hf)
        self.batch, self.seq = int(tr["batch"]), int(
            self.hf["seq"] if cpu else tr["seq"])
        self.kw = {"k_per_leaf": int(tr["k_per_leaf"]),
                   "cand_per_leaf": int(tr["cand_per_leaf"])}
        self.lr = float(tr["lr"])
        self.cc = program_gradcomp.CompressorConfig(
            **{**cfg["compressor"], **tr.get("compressor", {}),
               "seed": self.seed & hashing.MASK32})
        vocab = self.hf["vocab_size"]
        gen = traffic_gen.generator(self.seed, self.device, 4)
        toks = traffic_gen.zipf_keys(
            (int(tr["pool"]), self.batch, self.seq + 1), float(tr["zipf"]),
            vocab, gen).to(torch.int64)
        self.inputs_made(toks)
        self.batches = [{"tokens": t[:, :-1], "labels": t[:, 1:]}
                        for t in toks]
        self._init_group()
        params = self._init_params(M)
        names = flat(params)
        if not cpu and [[k, list(v.shape)] for k, v in names.items()] \
                != cfg["leaves"]:
            raise ValueError("the program's parameter tree is not the "
                             "configuration's leaves")
        self.names = list(names)
        g = traffic_gen.generator(self.seed, self.device, 5)
        self.subset = {k: torch.randint(0, v.numel(), (min(SUBSET,
                                                           v.numel()),),
                                        device=self.device, generator=g)
                       for k, v in names.items()}
        self.state = steps.CompressedTrainState(
            params=params, opt=adamw.init(params),
            error=program_gradcomp.init_error(params))
        del params, names
        self.ref = Reference(self._ref_config())
        if self.program == "control":
            self.step_fn = self._control_step
            self.compress_fn = self._control_compress
        else:
            step = steps.make_compressed_train_step_engine(
                self.arch, None, self.cc, lr=self.lr, expose=True,
                **self.kw)
            self.step_fn = self.program(step) if callable(self.program) \
                else step
            self.compress_fn = lambda g, e: \
                program_gradcomp.tree_compress_step_engine(
                    g, e, self.cc, None, **self.kw)
        # a sampled step's parameters, gradients and carried error are
        # copied into buffers made here, so that keeping one changes no
        # allocation of the window's (the state fills the card)
        like = {"params": flat(self.state.params),
                "grads": flat(self.state.params),
                "e": flat(self.state.error)}
        self.kept = [{key: {k: torch.empty_like(v) for k, v in tree.items()}
                      for key, tree in like.items()}
                     for _ in range(self.reservoir.size)]
        del like
        self.next = 0
        self.done = 0
        self.steps = 0
        self.routes = None
        for _ in range(int(tr.get("warm_steps", 2))):
            self.cycle()
        self.sync()

    def _init_params(self, M):
        gen = traffic_gen.generator(self.seed, self.device, 3)
        params = M.init_params(self.arch, gen,
                               dtype=getattr(torch, self.config["dtype"]),
                               device=self.device)
        std = float(self.config["initializer_range"])
        for k, v in flat(params).items():
            if k == "embed" or (v.dim() >= 3 and not k.endswith(".conv")):
                v.normal_(0.0, std, generator=gen)
        return params

    def _ref_config(self) -> dict:
        return {**self.hf, "num_local_experts": self.arch.held_experts,
                "expert_offset": self.arch.expert_offset}

    def _init_group(self):
        import torch.distributed as dist

        self.store_dir = tempfile.mkdtemp(prefix="perfbench-store-",
                                          dir=os.environ.get("TMPDIR"))
        store = dist.FileStore(os.path.join(self.store_dir, "store"), 1)
        backend = "nccl" if self.device.type == "cuda" else "gloo"
        kw = {"device_id": self.device} if backend == "nccl" else {}
        dist.init_process_group(backend, store=store, rank=0, world_size=1,
                                **kw)

    # -- a cycle --------------------------------------------------------
    def _gather(self, state, extra=None) -> dict:
        """Parameters and moments at the checked coordinates (float64)."""
        out = {}
        trees = [flat(state.params), flat(state.opt.mu), flat(state.opt.nu)]
        for k in self.names:
            idx = self.subset[k] if extra is None \
                else torch.cat([self.subset[k], extra[k][0]])
            out[k] = (idx,) + tuple(t[k].reshape(-1)[idx].to(torch.float64)
                                    for t in trees)
        return out

    @staticmethod
    def _compact(update: dict) -> dict:
        """Each leaf's sparse update as (ids, values) of its nonzero
        entries: one read of the leaf, no temporary of its size (a step
        the reservoir keeps costs little more than the others)."""
        out = {}
        for k, sp in flat(update).items():
            f = sp.reshape(-1)
            ids = torch.nonzero(f).squeeze(1)
            out[k] = (ids, f[ids])
        return out

    def cycle(self):
        from repro_torch.models import moe

        slot = self.reservoir.offer() if self.in_window else None
        first = "start" not in self.checkpoints
        j = self.next % len(self.batches)
        self.next += 1
        before = None
        if slot is not None:
            before = self._gather(self.state)
            kept = self.kept[slot]
            for key, tree in (("params", self.state.params),
                              ("e", self.state.error)):
                torch._foreach_copy_(list(kept[key].values()),
                                     list(flat(tree).values()))
        with record_function("bench.step"):
            with moe.count_routes() as routes, moe.count_drops() as drops:
                self.state, m = self.step_fn(self.state, self.batches[j])
            self.sync()
        self.done += 1
        if routes:
            got = torch.stack(routes)
            self.routes = got if self.routes is None else self.routes + got
        if first or slot is not None:
            update = self._compact(m["update"])
            grads = flat(m["grads"])
            if not first:
                torch._foreach_copy_(list(kept["grads"].values()),
                                     list(grads.values()))
                grads = kept["grads"]
            rec = {"batch": j, "t": self.done, "loss": m["loss"],
                   "comm": m["comm_bytes"], "grads": grads,
                   "params": None if first else kept["params"],
                   "e": None if first else kept["e"], "update": update,
                   "new_err": flat(self.state.error) if first else None,
                   "dropped": sum((d for d, _ in drops),
                                  torch.zeros((), device=self.device)),
                   "before": before,
                   "after": self._gather(self.state,
                                         update if first else None)}
            if first:  # kept on the host, out of the program's memory
                rec["grads"] = {k: v.cpu() for k, v in rec["grads"].items()}
                rec["new_err"] = {k: v.cpu()
                                  for k, v in rec["new_err"].items()}
                self.checkpoints["start"] = rec
            else:
                self.checkpoints[f"kept{slot}"] = rec
        del m
        if self.in_window:
            self.steps += 1
            self.window_ops += 1

    def start_window(self):
        super().start_window()
        self.steps = 0
        self.routes = None

    def end_metrics(self, window_s: float) -> dict:
        return {"step_ms": window_s * 1e3 / self.steps}

    def facts(self) -> dict:
        sizes = [math.prod(s) for _, s in self.config["leaves"]] \
            if self.device.type != "cpu" else \
            [t.numel() for t in flat(self.state.params).values()]
        out = {"gradcomp.sketch": {
            "live_slots": float(sum(sizes)), "rows": self.cc.rows,
            "table_bytes": float(len(sizes) * self.cc.rows * self.cc.width
                                 * 4)}}
        if self.routes is not None and self.steps:
            r = self.routes.to(torch.float64)
            out["moe.load_max"] = float(r.max() / r.mean())
            out["train.flops"] = flops.train_step_flops(
                self.hf, self.batch, self.seq, float(r.sum()) / self.steps)
        return out

    def release(self):
        """After the window, the program's state freed: each sampled
        step's new error, from the program's compression of the
        gradients and error that step kept."""
        self.state = self.kept = None
        for key, rec in self.checkpoints.items():
            if key != "start":
                with torch.no_grad():
                    _, ne, _ = self.compress_fn(_unflat(rec["grads"]),
                                                _unflat(rec["e"]))
                rec["new_err"] = flat(ne)
                del ne
        self.step_fn = self.compress_fn = None

    # -- the checks -----------------------------------------------------
    def checks(self) -> dict:
        out = {"moe_dropped": 0.0, "update_err": 0.0}
        for rec in self.checkpoints.values():
            out["moe_dropped"] = max(out["moe_dropped"],
                                     float(rec["dropped"]))
            for name, value in self._compression(rec).items():
                out[name] = max(out.get(name, 0.0), value)
            out["update_err"] = max(out["update_err"], self._update(rec))
            rec["e"] = rec["new_err"] = None
        self._p0 = None
        out["loss_err"] = out["grad_err"] = 0.0
        for rec in self.checkpoints.values():
            params = rec["params"] or self._first_params()
            loss, grads = float(rec["loss"]), rec["grads"]
            b = self.batches[rec["batch"]]
            want, wgrads = reference_grads(self.ref, params, b["tokens"],
                                           b["labels"])
            out["loss_err"] = max(out["loss_err"],
                                  abs(loss - want) / abs(want))
            for k, w in wgrads.items():
                d = (grads[k].to(w.device, torch.float32) - w).norm()
                out["grad_err"] = max(out["grad_err"], float(
                    d / w.norm().clamp_min(1e-30)))
            del params, grads, wgrads
            rec["params"] = rec["grads"] = self._p0 = None
        return out

    def _dense(self, rec, name, like):
        ids, vals = rec["update"][name]
        sp = torch.zeros(like.numel(), dtype=torch.float32,
                         device=self.device)
        sp[ids] = vals
        return sp.reshape(like.shape)

    def _compression(self, rec) -> dict:
        dev = self.device
        g = Lazy(self.names, lambda k: rec["grads"][k].to(dev))
        e = Lazy(self.names, lambda k: torch.zeros(
            rec["grads"][k].shape, dtype=torch.float32, device=dev)
            if rec["e"] is None else rec["e"][k])
        sp = Lazy(self.names, lambda k: self._dense(rec, k, rec["grads"][k]))
        ne = Lazy(self.names, lambda k: rec["new_err"][k].to(dev))
        return gradcomp.check(g, e, sp, ne, float(rec["comm"]), self.cc,
                              **self.kw)

    def _update(self, rec) -> float:
        """The AdamW step from the program's sparse update, against the
        reference's: the moments' relative error, and how many bfloat16
        ulps past one a parameter lies from the reference's."""
        worst = 0.0
        for k in self.names:
            idx, p1, m1, v1 = rec["after"][k]
            if rec["before"] is None:  # the first step, from the init
                p0 = flat(self._first_params())[k].reshape(-1)[idx]
                m0 = v0 = torch.zeros_like(p1)
            else:
                _, p0, m0, v0 = rec["before"][k]
            ids, vals = rec["update"][k]
            grad = torch.zeros(rec["grads"][k].numel(), dtype=torch.float32,
                               device=self.device)
            grad[ids] = vals
            p, m, v = ref_adamw.step(p0, grad[idx], m0, v0, rec["t"],
                                     self.lr)
            for got, want in ((m1, m), (v1, v)):
                worst = max(worst, float((got - want).abs().max()
                                         / want.abs().max().clamp_min(
                                             1e-300)))
            ulps = ((p1 - p).abs() / ref_adamw.bf16_ulp(p)).max()
            worst = max(worst, float(ulps) - 1.0)
        return worst

    def _first_params(self):
        from repro_torch.models import model as M

        if getattr(self, "_p0", None) is None:
            self._p0 = self._init_params(M)
        return self._p0

    # -- the control ----------------------------------------------------
    def _control_grads(self, params, batch):
        dtype = getattr(torch, self.config["dtype"])
        loss, grads = reference_grads(self.fp8, params, batch["tokens"],
                                      batch["labels"], dtype)
        return torch.tensor(loss), _unflat(grads)

    def _control_compress(self, grads, error):
        sparse, new_err, stats = gradcomp.step(
            flat(grads), flat(error), self.cc, dtype=torch.float32,
            **self.kw)
        return _unflat(sparse), _unflat(new_err), stats

    def _control_step(self, state, batch):
        """The reference in the program's place: its gradients with every
        matrix product's inputs rounded to float8_e4m3fn, its compression
        (in float32) and its AdamW, the state updated in place."""
        from repro_torch.optim import adamw

        if not hasattr(self, "fp8"):
            self.fp8 = Reference(self._ref_config(),
                                 matmul_round=torch.float8_e4m3fn)
        loss, grads = self._control_grads(state.params, batch)
        sparse, new_err, stats = self._control_compress(grads, state.error)
        sparse, new_err = flat(sparse), flat(new_err)
        t = int(state.opt.step) + 1
        mu, nu = flat(state.opt.mu), flat(state.opt.nu)
        for k, p in flat(state.params).items():
            p1, m1, v1 = ref_adamw.step(p, sparse[k], mu[k], nu[k], t,
                                        self.lr, dtype=torch.float32)
            p.copy_(p1)
            mu[k].copy_(m1)
            nu[k].copy_(v1)
        opt = adamw.AdamWState(step=state.opt.step + 1, mu=state.opt.mu,
                               nu=state.opt.nu)
        return (state._replace(opt=opt, error=_unflat(new_err)),
                {"loss": loss, "grads": grads, "update": _unflat(sparse),
                 "comm_bytes": stats["comm_bytes"]})

    def close(self):
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        if hasattr(self, "store_dir"):  # set-up may fail before the group
            shutil.rmtree(self.store_dir, ignore_errors=True)
