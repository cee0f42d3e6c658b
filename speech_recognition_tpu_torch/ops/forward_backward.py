"""Log-space forward-backward (sum-product) over epsilon-closed graphs.

Counterpart of ``speech_recognition_tpu/ops/forward_backward.py``:
alpha / beta passes in score space (``log p = -cost``), the frame
recursion a logsumexp matvec, same-column epsilon moves as
depth-bounded ``logaddexp`` passes (each eps hop's destination re-emits
the frame).  Outputs are what soft EM and word confidence need: state
posteriors ``gamma``, expected frame-edge counts ``xi_sum`` and the
evidence ``log Z``.

Two passes, each batched over a leading ``B`` (the JAX ``vmap``,
written out):

* :func:`forward_backward`: dense ``[S, S]`` matrices, shared or one per
  item (``models.graph.pad_graphs``), ``xi_mode`` "dense" (``[B, S, S]``
  counts) or "band" (``[B, 3, S]``, the M-step's self / step / skip
  diagonals).  Kernel K16 on CUDA tensors.
* :func:`forward_backward_banded`: a ``BandedGraph`` (band ``[3, S]``,
  optional static cross edges, the ``[R, L]`` eps block; shared or one
  per item with a leading ``B``).  Kernel K15 on CUDA tensors.

``forward_backward_plain`` / ``forward_backward_banded_plain`` are the
plain versions: Python frame loops of tensor ops that follow the JAX
formulas op for op (the ``_lse_mv`` / ``_lse_rows`` max shift,
``logaddexp`` for the eps passes, ``exp(min(., 50))``, frames past
``n_frames`` frozen in alpha and beta, beta at ``n_frames - 1`` set to
``end_scores``, gamma 0 past ``n_frames``).  They serve CPU tensors and
the tests; the wrappers in ``ops.forward_backward_kernels`` launch the
kernels for CUDA tensors or raise.

The cross-edge pullback (JAX ``_segment_lse``, a scatter) runs on an
inverse index of ``cross_src`` built once per call on the host
(:func:`cross_inverse`), so the sums have a fixed order on every device.
Only real cross edges (``cross_cost < POS_INF / 2``) are indexed: an
absent edge adds ``exp(NEG_INF - m) = 0``, which the JAX sum also adds.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from speech_recognition_tpu_torch.ops.viterbi_banded import MAX_BAND, BandedGraph
from speech_recognition_tpu_torch.utils.numerics import NEG_INF, POS_INF

__all__ = ["FBResult", "costs_to_scores", "forward_backward", "forward_backward_banded",
           "forward_backward_plain", "forward_backward_banded_plain", "cross_inverse",
           "end_positions"]


class FBResult(NamedTuple):
    gamma: torch.Tensor  # [B, T, S] posterior state occupancy (probability)
    # expected frame-edge counts: [B, S, S] (xi_mode "dense", [to, from])
    # or [B, MAX_BAND + 1, S] with xi_sum[b, d, u] the count of u -> u + d
    xi_sum: torch.Tensor
    log_z: torch.Tensor  # [B] log evidence
    # [B, S] counts of the static cross edges, by destination (banded pass
    # on graphs with cross edges only, else None)
    xi_cross: Optional[torch.Tensor] = None


def costs_to_scores(cost):
    """Cost (POS_INF-padded) -> log-probability score (NEG_INF-padded)."""
    return torch.where(cost >= POS_INF / 2, NEG_INF, -cost)


def _lse(z, dim):
    """logsumexp over ``dim`` with a finite-max shift; NEG_INF where the
    maximum is not finite (JAX ``_lse_mv`` / ``_lse_rows``)."""
    m = z.amax(dim)
    fin = torch.isfinite(m)
    ms = torch.where(fin, m, 0.0)
    out = torch.log(torch.exp(z - ms.unsqueeze(dim)).sum(dim)) + ms
    return torch.where(fin, out, NEG_INF)


def _logsumexp(x):
    """``jax.scipy.special.logsumexp`` over the last axis: -inf where
    every entry is -inf."""
    m = x.amax(-1)
    ms = torch.where(torch.isfinite(m), m, 0.0)
    return torch.log(torch.exp(x - ms[..., None]).sum(-1).abs()) + ms


def _batched(x, b, dims):
    """``x`` with a leading batch axis of ``b`` (a view where shared)."""
    return x if x.dim() == dims + 1 else x.expand((b,) + tuple(x.shape))


def _posteriors(alphas, betas, log_z, n_frames, end_scores):
    """gamma ``[B, T, S]`` of the alpha and beta planes (beta at
    ``n_frames - 1`` set to ``end_scores``)."""
    t_len = alphas.shape[1]
    frame = torch.arange(t_len, device=alphas.device)
    betas = torch.where((frame[None, :] == n_frames[:, None] - 1)[..., None],
                        end_scores[:, None, :], betas)
    log_gamma = alphas + betas - log_z[:, None, None]
    valid = (frame[None, :] < n_frames[:, None])[..., None]
    return torch.where(valid, torch.exp(torch.clamp(log_gamma, max=50.0)), 0.0), betas


def _prep(nll, n_frames, end_scores):
    b, _, s = nll.shape
    dev = nll.device
    n_frames = n_frames.to(dev, torch.int64)
    if end_scores is None:
        end_scores = torch.zeros((b, s), dtype=nll.dtype, device=dev)
    return (-torch.clamp(nll, max=POS_INF), n_frames,
            _batched(end_scores.to(dev, nll.dtype), b, 1))


def forward_backward_plain(nll, trans_cost, init_cost, n_frames, eps_trans=None,
                           eps_depth: int = 1, end_scores=None, xi_mode: str = "dense"):
    """K16's plain version: the dense pass of :func:`forward_backward`."""
    if xi_mode not in ("dense", "band"):
        raise ValueError(f"unknown xi_mode {xi_mode!r}")
    b, t_len, s = nll.shape
    log_e, n_frames, end_scores = _prep(nll, n_frames, end_scores)
    log_t = _batched(costs_to_scores(trans_cost), b, 2)  # [B, to, from]
    log_init = _batched(costs_to_scores(init_cost), b, 1)
    log_eps = None if eps_trans is None else _batched(costs_to_scores(eps_trans), b, 2)

    def lse_mv(log_a, x):  # [B, to, from] + [B, from] -> [B, to]
        return _lse(log_a + x[:, None, :], 2)

    def eps_fwd(alpha, emis):
        if log_eps is None:
            return alpha
        for _ in range(eps_depth):
            alpha = torch.logaddexp(alpha, lse_mv(log_eps, alpha) + emis)
        return alpha

    def eps_bwd(beta, emis):
        if log_eps is None:
            return beta
        for _ in range(eps_depth):
            beta = torch.logaddexp(beta, lse_mv(log_eps.transpose(1, 2), beta + emis))
        return beta

    alpha = eps_fwd(log_init + log_e[:, 0], log_e[:, 0])
    alphas = [alpha]
    for t in range(1, t_len):
        a = eps_fwd(lse_mv(log_t, alpha) + log_e[:, t], log_e[:, t])
        alpha = torch.where((t < n_frames)[:, None], a, alpha)
        alphas.append(alpha)
    alphas = torch.stack(alphas, 1)
    log_z = _logsumexp(alphas[:, -1] + end_scores)

    beta = end_scores
    betas = [beta]
    for t in range(t_len - 2, -1, -1):
        emis = log_e[:, t + 1]
        nb = lse_mv(log_t.transpose(1, 2), eps_bwd(beta, emis) + emis)
        nb = torch.where((t == n_frames - 1)[:, None], end_scores, nb)
        beta = torch.where((t < n_frames)[:, None], nb, beta)
        betas.append(beta)
    betas = torch.stack(betas[::-1], 1)
    gamma, betas = _posteriors(alphas, betas, log_z, n_frames, end_scores)

    if xi_mode == "dense":
        xi = torch.zeros((b, s, s), dtype=nll.dtype, device=nll.device)
    else:
        # band_logt[d][u] = logT[u + d, u]
        u = torch.arange(s, device=nll.device)
        band_logt = torch.stack([
            torch.where(u + d < s, log_t[:, torch.clamp(u + d, max=s - 1), u], NEG_INF)
            for d in range(MAX_BAND + 1)], 1)
        xi = torch.zeros((b, MAX_BAND + 1, s), dtype=nll.dtype, device=nll.device)
    for t in range(1, t_len):
        a_prev, eb = alphas[:, t - 1], log_e[:, t] + betas[:, t]
        if xi_mode == "dense":
            m = a_prev[:, None, :] + log_t + eb[:, :, None] - log_z[:, None, None]
        else:
            m = torch.stack([a_prev + band_logt[:, d] + _unshift(eb, d)
                             for d in range(MAX_BAND + 1)], 1) - log_z[:, None, None]
        xi = xi + torch.where((t < n_frames)[:, None, None],
                              torch.exp(torch.clamp(m, max=50.0)), 0.0)
    return FBResult(gamma, xi, log_z)


def _shift(x, d):
    """``x[..., s - d]`` with NEG_INF fill (JAX ``_shift_scores``)."""
    if d == 0:
        return x
    pad = torch.full(x.shape[:-1] + (d,), NEG_INF, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x], -1)[..., : x.shape[-1]]


def _unshift(x, d):
    """``x[..., s + d]`` with NEG_INF fill (JAX ``_unshift_scores``)."""
    if d == 0:
        return x
    pad = torch.full(x.shape[:-1] + (d,), NEG_INF, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], -1)[..., d:]


def end_positions(word_ends, s: int):
    """``[..., S]`` int64: the LAST index ``l`` with ``word_ends[l] == s``,
    -1 for states that end no word (the JAX ``.at[word_ends].set(arange)``
    on the CPU, where the last of duplicate indices wins; padded graphs
    repeat state 0).  Deterministic on every device."""
    word_ends = word_ends.to(torch.int64)
    pos = torch.arange(word_ends.shape[-1], device=word_ends.device).expand(word_ends.shape)
    out = torch.full(word_ends.shape[:-1] + (s,), -1, dtype=torch.int64,
                     device=word_ends.device)
    return out.scatter_reduce(-1, word_ends, pos, reduce="amax")


def cross_inverse(cross_src, cross_cost):
    """The inverse index of the real cross edges (``cross_cost <
    POS_INF / 2``), by origin, in CSR form on the device of
    ``cross_src``: ``(offsets [..., S + 1], dests [..., S])`` int32, with
    the destinations of origin ``u`` at ``dests[off[u]:off[u + 1]]`` in
    ascending order.  Built on the host (a device-to-host copy) at each
    call of the kernel or the plain version; no graph of the CLI's paths
    has cross edges."""
    src = cross_src.cpu().numpy().astype(np.int64)
    real = cross_cost.cpu().numpy() < POS_INF / 2
    s = src.shape[-1]
    flat_src, flat_real = src.reshape(-1, s), real.reshape(-1, s)
    offs = np.zeros((flat_src.shape[0], s + 1), np.int32)
    dests = np.zeros((flat_src.shape[0], s), np.int32)
    for i, (sr, rl) in enumerate(zip(flat_src, flat_real)):
        d = np.flatnonzero(rl)
        order = np.argsort(sr[d], kind="stable")
        dests[i, : len(d)] = d[order]
        offs[i, 1:] = np.cumsum(np.bincount(sr[d], minlength=s))
    dev = cross_src.device
    return (torch.from_numpy(offs.reshape(src.shape[:-1] + (s + 1,))).to(dev),
            torch.from_numpy(dests.reshape(src.shape)).to(dev))


def _segment_lse(vals, offs, dests):
    """out[b, u] = LSE over the real cross edges u -> i of ``vals[b, i]``,
    NEG_INF where there is none (JAX ``_segment_lse``); ``offs`` /
    ``dests`` from :func:`cross_inverse`, one per item."""
    b, s = vals.shape
    counts = (offs[:, 1:] - offs[:, :-1]).to(torch.int64)  # [B, S]
    k = max(int(counts.max()), 1)
    slot = torch.arange(k, device=vals.device)
    idx = offs[:, :-1, None].to(torch.int64) + slot  # [B, S, K]
    live = slot < counts[..., None]
    dest = dests.to(torch.int64).gather(1, torch.where(live, idx, 0).reshape(b, -1))
    g = torch.where(live, vals.gather(1, dest).reshape(b, s, k), -torch.inf)
    m = g.amax(-1)
    ms = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.where(torch.isfinite(g), torch.exp(g - ms[..., None]), 0.0)
    tot = e.sum(-1)
    return torch.where(tot > 0, torch.log(tot) + ms, NEG_INF)


def _gather(x, idx):
    return x.gather(1, idx.to(torch.int64))


def forward_backward_banded_plain(nll, g: BandedGraph, n_frames, eps_depth: int = 1,
                                  end_scores=None, cross_index=None):
    """K15's plain version: the banded pass of
    :func:`forward_backward_banded`.  ``cross_index`` is
    :func:`cross_inverse`'s output (built here if not given)."""
    b, t_len, s = nll.shape
    log_e, n_frames, end_scores = _prep(nll, n_frames, end_scores)
    n_band = g.band.shape[-2]
    log_band = _batched(costs_to_scores(g.band), b, 2)  # [B, D, S]: edge s-d -> s
    log_blk = _batched(costs_to_scores(g.eps_block), b, 2)  # [B, R, L]
    log_init = _batched(costs_to_scores(g.init_cost), b, 1)
    starts, ends = _batched(g.word_starts, b, 1), _batched(g.word_ends, b, 1)
    start_pos, is_start = _batched(g.start_pos, b, 1), _batched(g.is_start, b, 1)
    end_pos = end_positions(ends, s)
    is_end = end_pos >= 0
    end_pos = torch.clamp(end_pos, min=0)
    has_cross = g.cross_src is not None
    if has_cross:
        cross_src = _batched(g.cross_src, b, 1).to(torch.int64)
        log_cross = _batched(costs_to_scores(g.cross_cost), b, 1)
        if cross_index is None:
            cross_index = cross_inverse(g.cross_src, g.cross_cost)
        offs, dests = (_batched(x, b, 1) for x in cross_index)

    def eps_fwd(alpha, emis):
        for _ in range(eps_depth):
            end_vals = _gather(alpha, ends)  # [B, L]
            base = _lse(log_blk.transpose(1, 2) + end_vals[:, :, None], 1)  # [B, R]
            cand = base + _gather(emis, starts)
            alpha = torch.logaddexp(alpha, torch.where(is_start, _gather(cand, start_pos),
                                                       NEG_INF))
        return alpha

    def eps_bwd(beta, emis):
        for _ in range(eps_depth):
            sv = _gather(beta, starts) + _gather(emis, starts)  # [B, R]
            contrib = _lse(log_blk + sv[:, :, None], 1)  # [B, L]
            beta = torch.logaddexp(beta, torch.where(is_end, _gather(contrib, end_pos),
                                                     NEG_INF))
        return beta

    alpha = eps_fwd(log_init + log_e[:, 0], log_e[:, 0])
    alphas = [alpha]
    for t in range(1, t_len):
        base = _lse(torch.stack([log_band[:, d] + _shift(alpha, d) for d in range(n_band)],
                                1), 1)
        if has_cross:
            base = torch.logaddexp(base, alpha.gather(1, cross_src) + log_cross)
        a = eps_fwd(base + log_e[:, t], log_e[:, t])
        alpha = torch.where((t < n_frames)[:, None], a, alpha)
        alphas.append(alpha)
    alphas = torch.stack(alphas, 1)
    log_z = _logsumexp(alphas[:, -1] + end_scores)

    beta = end_scores
    betas = [beta]
    for t in range(t_len - 2, -1, -1):
        emis = log_e[:, t + 1]
        y = eps_bwd(beta, emis) + emis
        nb = _lse(torch.stack([_unshift(log_band[:, d] + y, d) for d in range(n_band)], 1), 1)
        if has_cross:
            nb = torch.logaddexp(nb, _segment_lse(log_cross + y, offs, dests))
        nb = torch.where((t == n_frames - 1)[:, None], end_scores, nb)
        beta = torch.where((t < n_frames)[:, None], nb, beta)
        betas.append(beta)
    betas = torch.stack(betas[::-1], 1)
    gamma, betas = _posteriors(alphas, betas, log_z, n_frames, end_scores)

    # xi[d, u] += exp(alpha[t-1, u] + log_band[d, u+d] + (emis + beta)[t, u+d] - log Z)
    band_from = torch.stack([_unshift(log_band[:, d], d) for d in range(n_band)], 1)
    xi = torch.zeros((b, n_band, s), dtype=nll.dtype, device=nll.device)
    xi_cross = torch.zeros((b, s), dtype=nll.dtype, device=nll.device) if has_cross else None
    for t in range(1, t_len):
        a_prev, eb = alphas[:, t - 1], log_e[:, t] + betas[:, t]
        live = (t < n_frames)[:, None, None]
        m = torch.stack([a_prev + band_from[:, d] + _unshift(eb, d) for d in range(n_band)],
                        1) - log_z[:, None, None]
        xi = xi + torch.where(live, torch.exp(torch.clamp(m, max=50.0)), 0.0)
        if has_cross:
            mc = a_prev.gather(1, cross_src) + log_cross + eb - log_z[:, None]
            xi_cross = xi_cross + torch.where(live[:, :, 0],
                                              torch.exp(torch.clamp(mc, max=50.0)), 0.0)
    return FBResult(gamma, xi, log_z, xi_cross)


def forward_backward(nll, trans_cost, init_cost, n_frames, eps_trans=None, eps_depth: int = 1,
                     end_scores=None, xi_mode: str = "dense") -> FBResult:
    """Sum-product pass over a batch on dense graphs: kernel K16 for CUDA
    tensors, the plain version for CPU tensors.

    ``nll [B, T, S]`` emission costs in graph-state order; ``trans_cost``
    / ``eps_trans`` ``[S, S]`` or ``[B, S, S]`` (cost space, ``[to,
    from]``); ``init_cost [S]`` or ``[B, S]``; ``n_frames [B]``;
    ``end_scores [S]`` or ``[B, S]`` terminal log-probabilities (default
    0 everywhere).  ``xi_mode`` "dense" returns ``[B, S, S]`` counts,
    "band" the ``[B, 3, S]`` diagonals (off-band edges ignored)."""
    from speech_recognition_tpu_torch.ops.forward_backward_kernels import fb_dense

    return fb_dense(nll, trans_cost, init_cost, n_frames, eps_trans, eps_depth, end_scores,
                    xi_mode)


def forward_backward_banded(nll, g: BandedGraph, n_frames, eps_depth: int = 1,
                            end_scores=None) -> FBResult:
    """Sum-product pass over a batch on a banded graph: kernel K15 for CUDA
    tensors, the plain version for CPU tensors.

    ``nll [B, T, S]`` in graph-state order; ``g`` a ``BandedGraph`` whose
    arrays are shared or carry a leading ``B`` (``band``, ``init_cost``,
    ``word_starts``, ``word_ends``, ``eps_block``, ``start_pos``,
    ``is_start``, optional ``cross_src`` / ``cross_cost``); ``end_scores
    [S]`` or ``[B, S]`` (default 0).  ``xi_sum`` is ``[B, 3, S]``,
    ``xi_cross`` ``[B, S]`` on graphs with cross edges."""
    from speech_recognition_tpu_torch.ops.forward_backward_kernels import fb_banded

    return fb_banded(nll, g, n_frames, eps_depth, end_scores)
