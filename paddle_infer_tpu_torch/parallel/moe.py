"""Mixture-of-Experts FFN: gates, capacity dispatch, batched experts.

Port of ``paddle_infer_tpu/parallel/moe.py`` on one device: the Switch
(top-1), GShard (top-2) and naive top-k gates with their capacity
bookkeeping and load-balancing loss, ``fused_moe`` (gate → dispatch →
E expert MLPs as two batched products → combine) and ``MoELayer`` with
the reference's parameter names (``gate_weight [d, E]``, ``w1 [E, d,
f]``, ``b1 [E, f]``, ``w2 [E, f, d]``, ``b2 [E, d]``) and ``l_aux``.

The reference's gates return dense ``[N, E, C]`` combine and dispatch
tensors that one-hot einsums consume.  Each output of those einsums has
at most one nonzero term on dispatch and ``k`` on combine, so here the
gates return a compact ``Routing`` instead — per token and pick the
chosen expert, its slot in that expert's buffer, a keep flag and the
gate weight, all ``[N, k]`` — and dispatch is a scatter of token rows
into a zeroed ``[E·C + 1, d]`` buffer (dropped assignments land in a
trash row nobody reads), combine a gather of each token's ``k`` slots.
That is the reference's arithmetic without its two ``N·E·C·d``
products and its ``[N, E, C]`` float tensors.  ``dense_routing``
rebuilds the reference's ``(combine, dispatch)`` for tests.

Routing decisions are bitwise the reference's: both picks route on the
raw float32 logits (``torch.argmax`` takes the first maximum, as
``jnp.argmax``), GShard's second pick masks the winner's logit to
``-inf``, slot positions are integer cumulative sums, and the naive
gate orders ties by index (a stable sort) and grows each expert's
occupancy by every pick, dropped ones included.  The aux loss is taken
over all N tokens.  A ``valid`` mask (the serving step's real slots,
``serving/moe/ops.py``) keeps the other tokens out of the buffers: they
take no slot and no capacity, and are kept nowhere; without one (the
training path) every token routes.  Combine rounds the gate weights to
the activations' dtype first (the reference's ``combine.astype(
x.dtype)``) and sums the ``k`` terms in a fixed order in float32, never
with atomics.  Nothing reads the host, so the layer runs inside a
captured CUDA graph.

The experts' ``gelu`` is the tanh form (``jax.nn.gelu``'s default),
not the exact erf form of the dense MLP.  No hand-written kernel is
involved: the JAX package computes all of it as XLA einsums outside any
Pallas kernel, and here the expert products are ``torch.bmm``.

Expert parallelism: the stacked expert tensors carry the reference's
``("ep", ...)`` stamps, and on a serving mesh with ``ep > 1`` the
engine's placement splits them so shard e holds experts ``e·E/ep ..
(e+1)·E/ep - 1``.  ``ep_ffn`` then moves the ``[E, C, d]`` dispatch
buffer to the shards that own its experts (``global_scatter``, the
token -> expert all-to-all), runs each shard's experts there and brings
the outputs back for the combine (``global_gather``); off a mesh both
are identities.

Training: the layer is differentiable end to end, as the reference's
``fused_moe`` is through its VJP.  Gradients reach the gate weights
through the combine's gate probabilities and the aux loss's mean
probabilities, the tokens through the dispatch scatter (``index_copy_``
into the fresh buffer, which autograd records; the trash row and empty
slots take no gradient) and the combine gather, and the experts through
their ``bmm``s.  The aux loss's token fractions come from the hard
one-hot picks and carry no gradient, as the reference's one-hot mask
does not.  In training every token routes (no ``valid`` mask).  Under
the AMP rule every float operand is cast as the reference's dispatcher
casts the ``fused_moe`` op's (all of them to the low dtype at O2; the
router still scores in float32).  Parameters are created frozen, as
every layer of the port; a training model turns them on
(``GPTForCausalLM``).  The expert-parallel all-to-alls have no backward
yet: a mesh trains nothing until the mesh training (ROADMAP.md §1 step
4).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import amp
from . import topology


# ------------------------------------------------------------------ gates
def _capacity(n_tokens, num_experts, capacity_factor, top_k):
    c = int(math.ceil(top_k * n_tokens * capacity_factor / num_experts))
    return max(4, c)


class Routing(NamedTuple):
    """A gate's decisions for N tokens, ``k`` picks each: ``experts``
    and ``slots`` int64, ``keep`` bool, ``weights`` float32 (the gate
    weight of the pick, kept or not), all ``[N, k]``; ``aux`` the
    load-balancing loss (float32 scalar); ``capacity`` C and
    ``num_experts`` E the buffer's shape."""
    experts: torch.Tensor
    slots: torch.Tensor
    keep: torch.Tensor
    weights: torch.Tensor
    aux: torch.Tensor
    capacity: int
    num_experts: int


def _one_hot(idx, e):
    """``[N] -> [N, E]`` int64 one-hot without ``F.one_hot`` (which reads
    the host to check its range)."""
    return (idx[:, None] == torch.arange(e, device=idx.device)).long()


def _position(mask, idx):
    """Each token's 0-based position in its expert's buffer: the
    integer cumulative sum of ``mask [N, E]`` down the tokens, read at
    the token's expert (exact for any N)."""
    return torch.gather(torch.cumsum(mask, dim=0), 1, idx[:, None])[:, 0] - 1


def _slots(mask, idx, capacity, valid, offset=None):
    """One pick's slot positions and keep flags.  Tokens outside
    ``valid`` (when given) take no slot and are not kept."""
    if valid is not None:
        mask = mask * valid[:, None]
    pos = _position(mask, idx)
    if offset is not None:
        pos = pos + offset[idx]
    keep = pos < capacity
    return pos, (keep if valid is None else keep & valid), mask


def _balance_loss(mask, probs):
    """E · Σ_e fraction_of_tokens_e · mean_prob_e (Switch eq. 4), over
    all N tokens."""
    e = probs.shape[1]
    return e * torch.sum(mask.to(torch.float32).mean(dim=0)
                         * probs.mean(dim=0))


def switch_gate(logits, capacity, valid=None) -> Routing:
    """Switch Transformer top-1 gate with capacity and the
    load-balancing loss (reference ``switch_gate``)."""
    n, e = logits.shape
    lg = logits.to(torch.float32)
    probs = torch.softmax(lg, dim=-1)
    # route on the raw logits: softmax rounding can tie distinct logits
    idx = torch.argmax(lg, dim=-1)
    gate = torch.gather(probs, 1, idx[:, None])
    mask = _one_hot(idx, e)
    pos, keep, _ = _slots(mask, idx, capacity, valid)
    return Routing(idx[:, None], pos[:, None], keep[:, None], gate,
                   _balance_loss(mask, probs), int(capacity), e)


def gshard_gate(logits, capacity, valid=None) -> Routing:
    """GShard top-2 gate (reference ``gshard_gate``): the second expert
    weighted by its renormalized prob; top-1 picks fill the buffers
    first, top-2 picks the rest; the aux loss on the top-1 picks."""
    n, e = logits.shape
    lg = logits.to(torch.float32)
    probs = torch.softmax(lg, dim=-1)
    idx1 = torch.argmax(lg, dim=-1)
    mask1 = _one_hot(idx1, e)
    # the second pick masks the winner's LOGIT: zeroing its prob would
    # tie every underflowed tail prob at 0 and pick by index order
    idx2 = torch.argmax(torch.where(mask1 > 0, -torch.inf, lg), dim=-1)
    mask2 = _one_hot(idx2, e)
    g1 = torch.gather(probs, 1, idx1[:, None])[:, 0]
    g2 = torch.gather(probs, 1, idx2[:, None])[:, 0]
    denom = torch.clamp(g1 + g2, min=1e-9)
    g1, g2 = g1 / denom, g2 / denom
    p1, k1, routed1 = _slots(mask1, idx1, capacity, valid)
    p2, k2, _ = _slots(mask2, idx2, capacity, valid,
                       offset=routed1.sum(dim=0))
    return Routing(torch.stack([idx1, idx2], dim=1),
                   torch.stack([p1, p2], dim=1), torch.stack([k1, k2], dim=1),
                   torch.stack([g1, g2], dim=1),
                   _balance_loss(mask1, probs), int(capacity), e)


def naive_gate(logits, capacity, top_k=2, valid=None) -> Routing:
    """Plain top-k softmax gate (reference ``naive_gate``): picks by
    prob, ties to the lower index (``lax.top_k``'s order), weights
    renormalized over the k picks; each expert's occupancy grows by
    every pick, dropped or not.  No aux loss (0)."""
    n, e = logits.shape
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    vals, idxs = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idxs = vals[:, :top_k], idxs[:, :top_k]
    vals = vals / torch.clamp(vals.sum(dim=-1, keepdim=True), min=1e-9)
    occupancy = torch.zeros((e,), dtype=torch.long, device=logits.device)
    slots, keep = [], []
    for j in range(top_k):
        pos, kj, mask = _slots(_one_hot(idxs[:, j], e), idxs[:, j],
                               capacity, valid, offset=occupancy)
        slots.append(pos)
        keep.append(kj)
        occupancy = occupancy + mask.sum(dim=0)
    return Routing(idxs, torch.stack(slots, dim=1), torch.stack(keep, dim=1),
                   vals, torch.zeros((), dtype=torch.float32,
                                     device=logits.device), int(capacity), e)


_GATES = {"switch": switch_gate, "gshard": gshard_gate, "naive": naive_gate}


def route(logits, gate, top_k, capacity, valid=None) -> Routing:
    """The ``gate`` kind's routing of ``logits [N, E]`` into buffers of
    ``capacity`` slots (``top_k`` matters to the naive gate only), the
    tokens outside ``valid`` (when given) taking no slot."""
    if gate == "naive":
        return naive_gate(logits, capacity, top_k=top_k, valid=valid)
    return _GATES[gate](logits, capacity, valid=valid)


def dense_routing(r: Routing):
    """The reference gates' ``(combine [N, E, C] float32, dispatch [N,
    E, C] bool)`` rebuilt from a compact routing."""
    n, k = r.experts.shape
    dev = r.experts.device
    e_ax = torch.arange(r.num_experts, device=dev)[None, :, None]
    c_ax = torch.arange(r.capacity, device=dev)[None, None, :]
    combine = torch.zeros((n, r.num_experts, r.capacity),
                          dtype=torch.float32, device=dev)
    dispatch = torch.zeros(combine.shape, dtype=torch.bool, device=dev)
    for j in range(k):
        hit = ((r.experts[:, j, None, None] == e_ax)
               & (r.slots[:, j, None, None] == c_ax)
               & r.keep[:, j, None, None])
        combine = combine + r.weights[:, j, None, None] * hit
        dispatch = dispatch | hit
    return combine, dispatch


# ------------------------------------------------------------- fused op
def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


# ``getattr(jax.nn, activation)`` of the reference
_ACT = {"gelu": _gelu_tanh, "relu": F.relu, "silu": F.silu}


def _gate_logits(xt, gate_w):
    """The router's float32 logits ``[N, E]``."""
    return xt.to(torch.float32) @ gate_w.to(torch.float32)


def dispatch_tokens(xt, r: Routing):
    """Scatter token rows ``xt [N, d]`` into the per-expert buffers
    ``[E, C, d]`` (zeros where no token landed)."""
    e, c = r.num_experts, r.capacity
    buf = xt.new_zeros((e * c + 1, xt.shape[1]))
    trash = torch.full_like(r.experts[:, 0], e * c)
    for j in range(r.experts.shape[1]):
        dst = torch.where(r.keep[:, j], r.experts[:, j] * c + r.slots[:, j],
                          trash)
        buf.index_copy_(0, dst, xt)
    return buf[:e * c].view(e, c, xt.shape[1])


def _gate_dispatch(x, gate_w, gate, top_k, capacity):
    """Gate + capacity dispatch front half shared by every MoE variant:
    ``(routing, expert_in [E, C, d])`` for ``x [b, s, d]``."""
    xt = x.reshape(-1, x.shape[-1])
    r = route(_gate_logits(xt, gate_w), gate, top_k, capacity)
    return r, dispatch_tokens(xt, r)


def _expert_ffn(expert_in, w1, b1, w2, b2, activation):
    """Batched expert FFN body shared by the float and weight-only
    variants: ``[E,C,d] x [E,d,f]`` then ``[E,C,f] x [E,f,d]``."""
    h = torch.bmm(expert_in, w1.to(expert_in.dtype))
    h = _ACT[activation](h + b1[:, None, :].to(h.dtype))
    out = torch.bmm(h, w2.to(expert_in.dtype))
    return out + b2[:, None, :].to(out.dtype)


def _combine_out(x, r: Routing, out_e):
    """Combine back half shared by every variant: each token's ``k``
    slot outputs times its gate weights rounded to ``x.dtype``, summed
    in pick order in float32, cast back to ``x.dtype``."""
    e, c, d = out_e.shape
    flat = out_e.reshape(e * c, d)
    zero = torch.zeros_like(r.slots[:, 0])
    acc = None
    for j in range(r.experts.shape[1]):
        keep = r.keep[:, j]
        w = torch.where(keep, r.weights[:, j], 0.0).to(x.dtype)
        src = torch.where(keep, r.experts[:, j] * c + r.slots[:, j], zero)
        term = w.to(torch.float32)[:, None] \
            * flat.index_select(0, src).to(torch.float32)
        acc = term if acc is None else acc + term
    return acc.to(x.dtype).reshape(x.shape)


def moe_with(x, gate_w, gate, top_k, capacity_factor, ffn):
    """Gate → dispatch → ``ffn(expert_in [E, C, d])`` → combine for
    ``x [b, s, d]``, the capacity from the live token count ``b·s``:
    ``(out [b, s, d], aux float32 scalar)``.  Every fused variant (float,
    weight-only, int8) is this with its expert FFN."""
    n = x.shape[0] * x.shape[1]
    cap = _capacity(n, gate_w.shape[1], capacity_factor, top_k)
    r, expert_in = _gate_dispatch(x, gate_w, gate, top_k, cap)
    return _combine_out(x, r, ffn(expert_in)), r.aux.to(torch.float32)


def fused_moe(x, gate_w, w1, b1, w2, b2, gate="gshard", top_k=2,
              capacity_factor=2.0, activation="gelu"):
    """One-shot MoE (reference ``fused_moe``)."""
    return moe_with(x, gate_w, gate, top_k, capacity_factor,
                    lambda buf: ep_ffn(
                        lambda b, *w: _expert_ffn(b, *w, activation), buf,
                        w1, b1, w2, b2))


# --------------------------------------------------- expert parallelism
def _ep_degree(mesh, num_experts) -> int:
    return (mesh.shape["ep"] if topology.axis_if_divides(
        mesh, "ep", num_experts) else 1)


def ep_stacks(module, mesh):
    """``[(tensor, per-shard slices)]`` of ``module``'s own expert stacks
    (``dist_attr`` ``("ep", ...)``) on ``mesh``: shard e holds experts
    ``e·E/ep .. (e+1)·E/ep - 1`` on its device.  Empty when ``ep`` does
    not split them."""
    out = []
    tensors = list(module.named_parameters(recurse=False)) + list(
        module.named_buffers(recurse=False))
    for _, t in tensors:
        attr = getattr(t, "dist_attr", None)
        if t is None or not attr or attr[0] != "ep":
            continue
        ep = _ep_degree(mesh, t.shape[0])
        if ep == 1:
            continue
        n = t.shape[0] // ep
        out.append((t, [t[e * n:(e + 1) * n].contiguous().to(
            mesh.device(ep=e)) for e in range(ep)]))
    return out


def global_scatter(x):
    """Token -> expert all-to-all (the reference's ``global_scatter``):
    the expert-major buffer ``[E, C, d]`` split on its expert dim, shard
    e's experts moved to shard e's device.  Off a mesh (or with ``ep``
    not splitting E) the buffer itself, as one shard."""
    mesh = topology.get_current_mesh()
    ep = 1 if mesh is None else _ep_degree(mesh, x.shape[0])
    if ep == 1:
        return [x]
    n = x.shape[0] // ep
    return [x[e * n:(e + 1) * n].to(mesh.device(ep=e)) for e in range(ep)]


def global_gather(parts):
    """Expert -> token all-to-all (the reference's ``global_gather``):
    the shards' expert outputs back in expert order on the mesh's
    controller device."""
    if len(parts) == 1:
        return parts[0]
    dev = topology.get_current_mesh().controller
    return torch.cat([p.to(dev) for p in parts], dim=0)


def ep_ffn(ffn, expert_in, *stacks):
    """``ffn(expert_in, *stacks)`` with the experts where the current
    placement put them: each ep shard runs ``ffn`` on its slice of the
    buffer and of every split stack (a stack the placement left whole,
    such as a scalar scale, goes to every shard as it is)."""
    pl = topology.get_current_placement()
    split = None if pl is None else [pl.ep_parts(t) for t in stacks]
    if not split or all(p is None for p in split):
        return ffn(expert_in, *stacks)
    bufs = global_scatter(expert_in)
    outs = [ffn(buf, *[t if p is None else p[e]
                       for t, p in zip(stacks, split)])
            for e, buf in enumerate(bufs)]
    return global_gather(outs)


# ------------------------------------------------------------- the layer
def _xavier_uniform_(w: torch.Tensor, generator):
    """The reference ``XavierUniform`` with its fans of a stacked
    ``[E, in, out]`` weight (``in·out`` and ``E·out``)."""
    if w.dim() == 2:
        fan_in, fan_out = w.shape
    else:
        rf = math.prod(w.shape[2:])
        fan_in, fan_out = w.shape[1] * rf, w.shape[0] * rf
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w.uniform_(-limit, limit, generator=generator)


class MoELayer(nn.Module):
    """MoE FFN block (reference ``MoELayer``): gate → dispatch → E
    expert MLPs → combine, the experts one stacked parameter each.
    ``l_aux`` holds the last forward's load-balancing loss."""

    def __init__(self, d_model, d_hidden, num_experts, gate="gshard",
                 top_k=2, capacity_factor=2.0, activation="gelu",
                 device=None, dtype=torch.float32):
        super().__init__()
        if gate not in _GATES:
            raise ValueError(f"gate must be one of {sorted(_GATES)}")
        if activation not in _ACT:
            raise ValueError(f"activation {activation!r} not ported")
        self.num_experts = num_experts
        self.gate_kind = gate
        # capacity is sized for what the gate routes: switch is top-1,
        # gshard top-2, only naive honours top_k
        self.top_k = {"switch": 1, "gshard": 2}.get(gate, top_k)
        self.capacity_factor = capacity_factor
        self.activation = activation
        kw = dict(device=device, dtype=dtype)

        def param(*shape):
            return nn.Parameter(torch.empty(shape, **kw),
                                requires_grad=False)

        self.gate_weight = param(d_model, num_experts)
        self.w1 = param(num_experts, d_model, d_hidden)
        self.b1 = param(num_experts, d_hidden)
        self.w2 = param(num_experts, d_hidden, d_model)
        self.b2 = param(num_experts, d_model)
        for p in (self.w1, self.b1, self.w2, self.b2):
            p.dist_attr = ("ep",) + (None,) * (p.dim() - 1)
        self.l_aux: Optional[torch.Tensor] = None

    def reset_parameters(self, generator=None):
        for w in (self.gate_weight, self.w1, self.w2):
            _xavier_uniform_(w, generator)
        self.b1.zero_()
        self.b2.zero_()

    def forward(self, x):
        x, gate_w, w1, b1, w2, b2 = (amp.cast(t, "fused_moe") for t in (
            x, self.gate_weight, self.w1, self.b1, self.w2, self.b2))
        out, aux = fused_moe(x, gate_w, w1, b1, w2, b2,
                             gate=self.gate_kind, top_k=self.top_k,
                             capacity_factor=self.capacity_factor,
                             activation=self.activation)
        self.l_aux = aux
        return out

    def extra_repr(self):
        return (f"experts={self.num_experts}, gate={self.gate_kind}, "
                f"top_k={self.top_k}, cap={self.capacity_factor}")
