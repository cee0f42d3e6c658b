"""A Python emulation of the forward-backward kernels K15 and K16 as
``speech_recognition_tpu_torch/csrc/forward_backward.cu`` computes them:
the split layout (each item's forward scan and backward scan, neither
reading the other, then the combine pass that sums gamma and xi over
frames in ascending order), K16's lists of finite matrix entries and its
finite-entry logsumexp (``fin_lse``), and K15's eps pass a thread per
start row (end column), its sums serial over each finite span.

Arithmetic is float32 in the kernels' order of operations; exp and log
are torch's.  ``dense_lse`` is the dense loop K16 used before its lists
(``lse_row`` / ``lse_col``: a max pass and a sum pass over ascending
index, one term at a time), element for element with the same torch ops
as ``fin_lse``, so the two can be compared bit for bit: the rule that
lets the kernel skip the NEG_INF entries holds for any exp that is
deterministic and maps arguments below -256 to 0.
"""

import torch

from speech_recognition_tpu_torch.ops.forward_backward import _segment_lse, cross_inverse

NEG_INF = -1e30
HALF_INF = 0.5e30
POS_INF = 1e30
EXP_ZERO = -256.0  # the kernel's FB_EXP_ZERO
WIDE_SPAN = 64     # K15's FB_WIDE_SPAN


def f32(v):
    return torch.tensor(v, dtype=torch.float32)


def scores(cost):
    return torch.where(cost >= HALF_INF, f32(NEG_INF), -cost)


def emis(nll):
    return -torch.clamp(nll, max=POS_INF)


def lae(a, b):
    """The kernel's logaddexp."""
    m = torch.maximum(a, b)
    out = m + torch.log1p(torch.exp(-torch.abs(a - b)))
    return torch.where(torch.isinf(a) & (a == b), a, out)


def lse3(z0, z1, z2):
    m = torch.maximum(torch.maximum(z0, z1), z2)
    out = torch.log(torch.exp(z0 - m) + torch.exp(z1 - m) + torch.exp(z2 - m)) + m
    return torch.where(torch.isfinite(m), out, f32(NEG_INF))


# ---- K16: the lists and the logsumexp over them ----------------------------

def build_lists(cost, cols: bool, cap: int):
    """The kernel's ``build_list``: the finite entries of ``cost [S, S]``
    by row (``cols`` False) or by column, each in ascending index order,
    as CSR ``(off [S + 1], idx [cap], sc [cap])``; a row whose entries
    would end past ``cap`` is left out (it runs the dense loop)."""
    m = cost.t() if cols else cost
    s = m.shape[0]
    fin = m < HALF_INF
    off = torch.zeros(s + 1, dtype=torch.int64)
    off[1:] = torch.cumsum(fin.sum(1), 0)
    idx = torch.full((cap,), -1, dtype=torch.int64)
    sc = torch.full((cap,), float("nan"), dtype=torch.float32)
    for i in range(s):
        if off[i + 1] > cap:
            continue
        js = torch.nonzero(fin[i])[:, 0]
        idx[off[i]:off[i + 1]] = js
        sc[off[i]:off[i + 1]] = scores(m[i, js])
    return off, idx, sc


def dense_lse(cost, x, cols: bool):
    """The dense loop: LSE over j of score(cost[i, j]) + x[j] for every
    row i (cols: score(cost[j, i])), serial over ascending j."""
    sc = scores(cost.t() if cols else cost)
    s = sc.shape[0]
    mx = torch.full((s,), -float("inf"))
    for j in range(s):
        mx = torch.maximum(mx, sc[:, j] + x[j])
    tot = torch.zeros(s)
    for j in range(s):
        tot = tot + torch.exp((sc[:, j] + x[j]) - mx)
    return torch.where(torch.isfinite(mx), torch.log(tot) + mx, f32(NEG_INF))


def fin_lse(lists, cost, x, cols: bool, cap: int, stats=None):
    """The kernel's ``lse_fin`` for every row: the list's terms where the
    rule pins the dense answer down, the dense loop elsewhere.
    ``stats`` (a dict) counts the rows of each branch: "sum" (the
    list's sum), "max" (the known maximum), "dense"."""
    off, idx, sc = lists
    s = off.shape[0] - 1
    cnt = off[1:] - off[:-1]
    fits = off[1:] <= cap
    k_max = int(cnt[fits].max()) if bool(fits.any()) else 0
    ks = torch.arange(k_max)
    live = (ks[None, :] < cnt[:, None]) & fits[:, None]
    pos = torch.where(live, off[:-1, None] + ks[None, :], 0)
    col = torch.where(live, idx[pos], 0)
    ent = torch.where(live, sc[pos], 0.0)
    zall = f32(NEG_INF) + x.max()
    mf = torch.full((s,), -float("inf"))
    for k in range(k_max):
        mf = torch.where(live[:, k], torch.maximum(mf, ent[:, k] + x[col[:, k]]), mf)
    case_sum = fits & torch.isfinite(mf) & ((zall - mf) < EXP_ZERO)
    tot = torch.zeros(s)
    for k in range(k_max):
        tot = torch.where(live[:, k], tot + torch.exp((ent[:, k] + x[col[:, k]]) - mf), tot)
    known = fits & ~case_sum & ((cnt == 0) | (mf >= zall))
    mx = torch.where(cnt == 0, zall, mf)
    case_max = known & (~torch.isfinite(mx) | (mx <= -HALF_INF))
    out = torch.where(case_sum, torch.log(tot) + mf,
                      torch.where(torch.isfinite(mx), mx, f32(NEG_INF)))
    dense = ~(case_sum | case_max)
    if bool(dense.any()):
        out = torch.where(dense, dense_lse(cost, x, cols), out)
    if stats is not None:
        for name, m in (("sum", case_sum), ("max", case_max), ("dense", dense)):
            stats[name] = stats.get(name, 0) + int(m.sum())
    return out


# ---- the split layout ---------------------------------------------------------

def _logsumexp(x):
    m = x.max()
    ms = torch.where(torch.isfinite(m), m, f32(0.0))
    return torch.log(torch.exp(x - ms).sum().abs()) + ms


def _item(x, b, dims):
    return x[b] if x.dim() == dims + 1 else x


def _gamma(alpha, beta, log_z, nf):
    gam = torch.zeros_like(alpha)
    gam[:nf] = torch.exp(torch.clamp((alpha[:nf] + beta[:nf]) - log_z, max=50.0))
    return gam


def dense_split(nll, trans, init, nf, eps=None, depth=1, end=None, xi_mode="band", cap=None,
                check=False, stats=None):
    """K16 on CPU tensors: per item, the forward scan (row lists), the
    backward scan (column lists), then the combine.  ``cap`` is the
    lists' capacity (default: every entry); ``check`` asserts that every
    finite-entry LSE equals the dense loop bit for bit.  Returns
    ``(gamma, xi, log_z)``."""
    b_n, t_len, s = nll.shape
    cap = s * s if cap is None else cap
    gam_all, xi_all, z_all = [], [], []
    for b in range(b_n):
        mt, ip = _item(trans, b, 2), _item(init, b, 1)
        me = None if eps is None else _item(eps, b, 2)
        es = torch.zeros(s) if end is None else _item(end, b, 1)
        n = min(max(int(nf[b]), 0), t_len)
        e = emis(nll[b])
        lists = {(m, c): build_lists(mat, c, cap) for m, mat in (("t", mt), ("e", me))
                 if mat is not None for c in (False, True)}

        def lse(m, x, cols):
            mat = mt if m == "t" else me
            out = fin_lse(lists[(m, cols)], mat, x, cols, cap, stats)
            if check:
                want = dense_lse(mat, x, cols)
                assert torch.equal(out, want), (m, cols, (out - want).abs().max())
            return out

        # forward
        alpha = torch.empty((t_len, s))
        x = scores(ip) + e[0]
        for t in range(max(n, 1)):
            if t:
                x = lse("t", x, False) + e[t]
            if me is not None:
                for _ in range(depth):
                    x = lae(x, lse("e", x, False) + e[t])
            alpha[t] = x
        log_z = _logsumexp(x + es)
        # backward
        tl = max(n, 1) - 1
        beta = torch.empty((t_len, s))
        w = es.clone()
        beta[tl] = w
        for t in range(tl, 0, -1):
            y = w + e[t]
            if me is not None:
                for _ in range(depth):
                    w = lae(w, lse("e", y, True))
                    y = w + e[t]
            w = lse("t", y, True)
            beta[t - 1] = w
        # combine, frames ascending
        gam_all.append(_gamma(alpha, beta, log_z, n))
        if xi_mode == "dense":
            lt = scores(mt)
            acc = torch.zeros((s, s))
            for t in range(1, n):
                eb = e[t] + beta[t]
                acc = acc + torch.exp(torch.clamp(((alpha[t - 1][None, :] + lt) + eb[:, None])
                                                  - log_z, max=50.0))
        else:
            u = torch.arange(s)
            lt = scores(mt)
            lb = torch.stack([torch.where(u + d < s, lt[torch.clamp(u + d, max=s - 1), u],
                                          f32(NEG_INF)) for d in range(3)])
            acc = torch.zeros((3, s))
            for t in range(1, n):
                eb = e[t] + beta[t]
                ebd = torch.stack([torch.cat([eb[d:], torch.full((d,), NEG_INF)])
                                   for d in range(3)])
                acc = acc + torch.exp(torch.clamp(((alpha[t - 1][None, :] + lb) + ebd) - log_z,
                                                  max=50.0))
        xi_all.append(acc)
        z_all.append(log_z)
    return torch.stack(gam_all), torch.stack(xi_all), torch.stack(z_all)


def spans(blk, cols: bool):
    """The finite spans ``(lo, hi)`` of ``blk [R, L]``'s rows (cols:
    columns), (0, 0) where there is none."""
    fin = (blk.t() if cols else blk) < HALF_INF
    n = fin.shape[1]
    any_ = fin.any(1)
    lo = torch.argmax(fin.int(), 1)
    hi = n - torch.argmax(fin.int().flip(1), 1)
    return torch.where(any_, lo, 0), torch.where(any_, hi, 0)


def span_lse(lo, hi, z):
    """LSE over each span [lo[i], hi[i]) of the terms ``z(i, k)``, summed
    serially in ascending k (a thread a row); NEG_INF where the span is
    empty or the maximum is not finite."""
    k_max = int((hi - lo).max()) if lo.numel() else 0
    m = torch.full(lo.shape, -float("inf"))
    terms = []
    for j in range(k_max):
        k = lo + j
        live = k < hi
        zk = z(torch.where(live, k, lo))
        terms.append((live, zk))
        m = torch.where(live, torch.maximum(m, zk), m)
    tot = torch.zeros(lo.shape)
    for live, zk in terms:
        tot = torch.where(live, tot + torch.exp(zk - m), tot)
    ok = (hi > lo) & torch.isfinite(m)
    return torch.where(ok, torch.log(tot) + m, f32(NEG_INF))


def banded_split(nll, g, nf, depth=1, end=None):
    """K15 on CPU tensors (``g`` a port ``BandedGraph``, shared or per
    item): the forward scan, the backward scan, the combine.  Returns
    ``(gamma, xi, log_z, xi_cross)``."""
    b_n, t_len, s = nll.shape
    per = g.band.dim() == 3
    cross_all = cross_inverse(g.cross_src, g.cross_cost) if g.cross_src is not None else None
    out = []
    for b in range(b_n):
        it = (lambda x: x[b]) if per else (lambda x: x)
        band, init, blk = scores(it(g.band)), it(g.init_cost), it(g.eps_block)
        starts, ends = it(g.word_starts).long(), it(g.word_ends).long()
        start_pos, is_start = it(g.start_pos).long(), it(g.is_start)
        cross = g.cross_src is not None
        if cross:
            csrc, lc = it(g.cross_src).long(), scores(it(g.cross_cost))
            offs, dests = (it(x) for x in cross_all)
        es = torch.zeros(s) if end is None else _item(end, b, 1)
        n = min(max(int(nf[b]), 0), t_len)
        e = emis(nll[b])
        sb = scores(blk)
        rlo, rhi = spans(blk, False)
        clo, chi = spans(blk, True)
        end_pos = torch.full((s,), -1, dtype=torch.int64)
        for l, st in enumerate(ends.tolist()):
            end_pos[st] = l
        rows = torch.arange(sb.shape[0])
        cols = torch.arange(sb.shape[1])

        def shift(x, d):
            return torch.cat([torch.full((d,), NEG_INF), x[:s - d]]) if d else x

        def unshift(x, d):
            return torch.cat([x[d:], torch.full((d,), NEG_INF)]) if d else x

        # forward
        alpha = torch.empty((t_len, s))
        x = scores(init) + e[0]
        for t in range(max(n, 1)):
            if t:
                base = lse3(*[band[d] + shift(x, d) for d in range(3)])
                if cross:
                    base = lae(base, x[csrc] + lc)
                x = base + e[t]
            for _ in range(depth):
                v = span_lse(rlo, rhi, lambda k: sb[rows, k] + x[ends[k]]) + e[t][starts]
                x = lae(x, torch.where(is_start, v[start_pos], f32(NEG_INF)))
            alpha[t] = x
        log_z = _logsumexp(x + es)
        # backward
        tl = max(n, 1) - 1
        beta = torch.empty((t_len, s))
        w = es.clone()
        beta[tl] = w
        for t in range(tl, 0, -1):
            for p in range(depth):
                vl = span_lse(clo, chi, lambda k: sb[k, cols] + (w[starts[k]] + e[t][starts[k]]))
                w = lae(w, torch.where(end_pos >= 0, vl[end_pos.clamp(min=0)], f32(NEG_INF)))
                if p + 1 == depth:
                    w = w + e[t]
            nb = lse3(*[unshift(band[d] + w, d) for d in range(3)])
            if cross:
                nb = lae(nb, _segment_lse((lc + w)[None], offs[None], dests[None])[0])
            w = nb
            beta[t - 1] = w
        # combine, frames ascending
        gam = _gamma(alpha, beta, log_z, n)
        lb = torch.stack([unshift(band[d], d) for d in range(3)])
        acc = torch.zeros((3, s))
        accx = torch.zeros(s) if cross else None
        for t in range(1, n):
            eb = e[t] + beta[t]
            ebd = torch.stack([unshift(eb, d) for d in range(3)])
            acc = acc + torch.exp(torch.clamp(((alpha[t - 1][None, :] + lb) + ebd) - log_z,
                                              max=50.0))
            if cross:
                accx = accx + torch.exp(torch.clamp(((alpha[t - 1][csrc] + lc) + eb) - log_z,
                                                    max=50.0))
        out.append((gam, acc, log_z, accx))
    gam, xi, z, xc = zip(*out)
    return (torch.stack(gam), torch.stack(xi), torch.stack(z),
            torch.stack(xc) if xc[0] is not None else None)
