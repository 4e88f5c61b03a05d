"""int8 gradient compression with error feedback.

The port of :mod:`repro.dist.compression`. Symmetric per-tensor int8
quantization (:func:`_q8`: scale ``max|x| / 127``, a zero scale taken as
1.0, ``round`` half to even as ``jnp.round``); error feedback (Karimireddy
et al., 2019) carries each participant's quantization residual into the
next step so the accumulated update stays unbiased.

"Per tensor" is per tensor of the reference's parameter tree, whose layers
are stacked on a leading axis (its scan). The port keeps a list of
per-layer trees instead, so on a tree the functions here take a list node
as that stacked axis: the leaves at the same place in every element of a
list share one scale (:func:`scale_groups`), and the numbers are the
reference's on its stacked tree.

The reference's ``compressed_psum`` is a bandwidth model: it sums the
dequantized f32 values with ``jax.lax.psum``, so XLA moves f32. Here the
int8 payload and one f32 scale per tensor are what cross the wire: every
rank quantizes its leaves, ONE ``all_gather`` moves every leaf's int8
values end to end in a flat buffer and one more the scales
(:meth:`~repro_torch.dist.group.DataGroup.all_gather`), and every rank
dequantizes and sums the ranks' parts in rank order, so all ranks hold
bitwise-equal sums.

Bytes a rank receives for N values in L tensors over n ranks: the int8
gather (n - 1)(N + 4L), against a ring f32 ``all_reduce``'s 2(n - 1)/n ·
4N (:func:`wire_bytes`). Their ratio is about n / 8: 4x fewer bytes at 2
ranks, 2x at 4, none at 8. The reference's "4x" holds for a psum of int8
values, which int8 cannot carry without overflow; a gather of int8 grows
with n.

Under tensor parallelism (a ``model`` group, the reference's "model"
axis) a rank holds only its slices of the split leaves, while the
reference's scale is the absmax of the whole logical tensor
(``jnp.max(jnp.abs(x))`` spans every shard under pjit). So each scale
group's absmax is taken over the rank's slices and then maxed over the
model group: ONE ``all_reduce`` MAX of an ``(n_groups,)`` f32 vector
(:func:`_group_scales`). Quantizing, dequantizing and the residual stay
elementwise on the slice, so a rank's int8 values, scales and residual
are bitwise its slice of what one rank holding the whole tensors
computes. Whole leaves of which a rank uses a part (``Split.model_sum``)
must be summed over the model group before they reach the wire
(``trainer.sum_model_shares_``); every rank then holds the same values.

Under the FSDP fallback a leaf split over the data group keeps its WHOLE
local gradient and whole residual on every rank (the reference's
semantics: each participant quantizes its whole ``g + ef``), but a rank
needs only its slice of the sum. ``split=`` names those leaves' dims:
the int8 values then cross in ONE ``all_to_all_single`` (each rank sends
rank j its slice j of every split leaf and every whole leaf entire, in
leaf order) and the scales in one ``all_gather``; each rank sums the
ranks' dequantized parts in rank order, bitwise the slice of the gather's
sum. A rank receives (n - 1)(W + F / n) int8 values for W values in whole
leaves and F in split ones (:func:`wire_bytes`).
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


def _q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: returns (q, scale), the
    scale computed in ``x``'s dtype and returned in f32, as the
    reference's."""
    s = x.abs().max() / 127.0
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return q, s.float()


def _dq(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.float() * s


def _like(tree, leaves):
    """A tree like ``tree`` whose leaves are ``leaves``, in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def scale_groups(tree) -> Tuple[List[int], int]:
    """(each leaf's scale group, in ``tree_leaves`` order; the number of
    groups): leaves whose paths differ only in list indices share a group,
    as the rows of one stacked tensor of the reference share its scale."""
    ids: dict = {}
    out: List[int] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, list):
            for v in node:
                walk(v, path + (None,))
        else:
            out.append(ids.setdefault(path, len(ids)))

    walk(tree, ())
    return out, len(ids)


def _scales(amax: torch.Tensor, gid: torch.Tensor, n_groups: int,
            model=None) -> torch.Tensor:
    """(n_groups,) f32: each group's ``max|x| / 127`` from its leaves'
    absmax ``amax``, a zero scale taken as 1.0. ``model``: a group over
    which the leaves are a rank's slices; the absmax is then maxed over it
    (one ``all_reduce`` MAX of the vector), the whole tensors' absmax."""
    a = amax.new_zeros(n_groups).scatter_reduce(0, gid, amax, "amax")
    if model is not None:
        model.pmax_(a)
    s = a / 127.0
    return torch.where(s == 0.0, torch.ones_like(s), s)


def _group_scales(leaves, gid: torch.Tensor, n_groups: int,
                  model=None) -> torch.Tensor:
    """:func:`_scales` of the leaves themselves."""
    return _scales(torch.stack(torch._foreach_norm(leaves, float("inf"))),
                   gid, n_groups, model)


def _quantize(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The int8 values of ``x`` at scale ``s`` (broadcast): ``round`` half
    to even, clamped to +-127."""
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)


def compress_decompress(grads, ef_state=None, model=None):
    """Quantize-dequantize every tensor with error feedback: the single-
    participant path (a list node's elements are the stacked axis:
    :func:`scale_groups`). ``model``: the tensor-parallel group whose
    ranks hold slices of the leaves (the scales are the whole tensors').

    ``ef_state`` carries each leaf's f32 residual (None on the first
    step). Returns (grads', ef_state') where grads' is what the compressed
    all-reduce would deliver (in each leaf's dtype) and ef_state' the
    residual to re-inject. Both are written into the tensors given:
    grads' are ``grads``' own tensors and ef_state' ``ef_state``'s (new
    tensors when it is None), overwritten leaf by leaf, so the wire holds
    one leaf's temporaries, not a second tree; a caller that still needs
    its inputs passes clones. Each leaf's ``g + ef`` is formed twice, once
    for the absmax and once to quantize."""
    leaves = tree_leaves(grads)
    efs = None if ef_state is None else tree_leaves(ef_state)

    def e_of(i):
        return leaves[i].float() + (0.0 if efs is None else efs[i])

    ids, n_groups = scale_groups(grads)
    amax = torch.stack([e_of(i).abs().amax() for i in range(len(leaves))])
    s = _scales(amax, torch.tensor(ids, device=amax.device), n_groups,
                model)
    resids = []
    for i, (g, gi) in enumerate(zip(leaves, ids)):
        e = e_of(i)
        out = _dq(_quantize(e, s[gi]), s[gi])
        resids.append(e.sub_(out) if efs is None
                      else torch.sub(e, out, out=efs[i]))
        g.copy_(out)
    return grads, _like(grads, resids)


def _q8_flat(leaves, gid: torch.Tensor, n_groups: int, model=None):
    """Every f32 leaf quantized with its group's scale, end to end: (the
    leaves' values (N,) f32, their int8 values (N,), the group scales
    (n_groups,) f32, each value's scale (N,) f32). The numbers of
    :func:`compress_decompress` (one division by the scale per value), in
    a few kernels over the concatenation instead of a handful per leaf."""
    for x in leaves:
        if x.dtype != torch.float32:
            raise TypeError(f"the compressed wire takes f32 leaves, got "
                            f"{x.dtype}")
    flat = torch.cat([x.reshape(-1) for x in leaves])
    scales = _group_scales(leaves, gid, n_groups, model)
    per = torch.repeat_interleave(scales[gid], _sizes(leaves),
                                  output_size=flat.numel())
    return flat, _quantize(flat, per), scales, per


def _sizes(leaves) -> torch.Tensor:
    """Each leaf's element count, on the leaves' device."""
    return torch.tensor([x.numel() for x in leaves], device=leaves[0].device)


def _dequant_sum(qs: torch.Tensor, ss: torch.Tensor, gid: torch.Tensor,
                 sizes: torch.Tensor) -> torch.Tensor:
    """Every rank's int8 part ``qs[r]`` (leaves of ``sizes`` values end to
    end) dequantized with its group scales ``ss[r]`` and the parts summed
    in rank order (f32)."""
    total = None
    for r in range(qs.shape[0]):
        part = qs[r].float() * torch.repeat_interleave(
            ss[r][gid], sizes, output_size=qs.shape[1])
        total = part if total is None else total + part
    return total


def _gathered_sum(group, q: torch.Tensor, scales: torch.Tensor,
                  gid: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """The wire: ONE all_gather of the int8 values and one of the scales;
    then every rank's part dequantized and summed in rank order (f32)."""
    return _dequant_sum(group.all_gather(q), group.all_gather(scales), gid,
                        sizes)


def _unflat(flat: torch.Tensor, like):
    """Views of ``flat`` shaped as the leaves of ``like``, in a tree like
    it."""
    out, off = [], 0
    for x in tree_leaves(like):
        out.append(flat[off: off + x.numel()].view_as(x))
        off += x.numel()
    return _like(like, out)


def _split_sum(group, q: torch.Tensor, scales: torch.Tensor, leaves,
               gid, dims):
    """The FSDP wire: ONE ``all_to_all_single`` of the int8 values, rank
    j getting slice j (along ``dims[i]``) of every split leaf and every
    whole leaf entire, in leaf order, and one ``all_gather`` of the
    scales; then every rank's part dequantized and summed in rank order
    (f32). Returns (the flat sum of this rank's parts, their shapes)."""
    n = group.size
    vals, off = [], 0
    for x in leaves:
        vals.append(q[off: off + x.numel()].view(x.shape))
        off += x.numel()
    sends = [[v.reshape(-1) if d is None
              else v.chunk(n, d)[j].reshape(-1)
              for v, d in zip(vals, dims)] for j in range(n)]
    shapes = [tuple(x.shape) if d is None
              else tuple(x.chunk(n, d)[group.index].shape)
              for x, d in zip(leaves, dims)]
    send = torch.cat([t for part in sends for t in part])
    sizes = torch.tensor([math.prod(sh) for sh in shapes],
                         device=q.device)
    return _dequant_sum(group.all_to_all(send), group.all_gather(scales),
                        gid, sizes), shapes


def compressed_psum_with_residual(x, group, model=None, split=None):
    """:func:`compressed_psum` that also returns this rank's quantization
    residual ``x - dq(q8(x))`` (a tree like ``x``): what the train step's
    error feedback carries into the next step. ``x``: an f32 tensor or a
    tree of them (a list node's elements share their scales:
    :func:`scale_groups`); all of them cross the wire in one collective.

    ``model``: the tensor-parallel group whose ranks hold slices of the
    leaves (the scales are the whole tensors', one ``all_reduce`` MAX).
    ``split``: a tree like ``x`` of each leaf's dim split over ``group``
    (the FSDP fallback), or None for a leaf every rank holds whole; the
    sum of such a leaf comes back as this rank's contiguous slice of it
    along that dim (:func:`_split_sum`), the residual whole."""
    leaves = tree_leaves(x)
    ids, n_groups = scale_groups(x)
    gid = torch.tensor(ids, device=leaves[0].device)
    flat, q, scales, per = _q8_flat(leaves, gid, n_groups, model)
    resid = _unflat(flat - q.float() * per, x)
    dims = None if split is None else [
        d for d, _ in tree_leaves(tree_map(lambda d, t: (d, t), split, x))]
    if dims is None or all(d is None for d in dims):
        return _unflat(_gathered_sum(group, q, scales, gid, _sizes(leaves)),
                       x), resid
    total, shapes = _split_sum(group, q, scales, leaves, gid, dims)
    out, off = [], 0
    for sh in shapes:
        k = math.prod(sh)
        out.append(total[off: off + k].view(sh))
        off += k
    return _like(x, out), resid


def compressed_psum(x, group):
    """The sum over ``group`` (a :class:`~repro_torch.dist.group
    .DataGroup`) of every rank's int8-quantized ``x``: each rank quantizes
    locally, int8 values and one f32 scale per tensor cross the wire, and
    the sum is over the dequantized values. ``x``: an f32 tensor or a tree
    of them; returns the same structure, f32."""
    return compressed_psum_with_residual(x, group)[0]


def wire_bytes(n_values: int, n_tensors: int, n_ranks: int,
               split_values: int = 0) -> dict:
    """Bytes one rank receives a step for ``n_values`` f32 gradient values
    in ``n_tensors`` tensors over ``n_ranks``: the int8 gather's payload
    and scales, and a ring f32 ``all_reduce``'s (counted, not timed).
    ``split_values``: how many of the values are in leaves split over the
    ranks (the FSDP fallback); ``int8_all_to_all`` is then the split
    wire's payload and scales, a rank receiving every rank's slice of
    those and every whole leaf entire."""
    out = {"int8_gather": (n_ranks - 1) * (n_values + 4 * n_tensors),
           "f32_ring_all_reduce": 2 * (n_ranks - 1) * 4 * n_values
           // n_ranks}
    if split_values:
        whole = n_values - split_values
        out["int8_all_to_all"] = (n_ranks - 1) * (
            whole + split_values // n_ranks + 4 * n_tensors)
    return out
