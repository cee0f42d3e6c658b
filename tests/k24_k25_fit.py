"""The mixture-fit kernels K24 (k-means) and K25 (EM) of
``speech_recognition_tpu_torch/csrc/gmm_fit.cu`` emulated in numpy float32,
in their order of summation, one fit at a time.

Per pass over a fit's frames: each frame's NLL under mixture m as two
chains over d (x^2 w1 and x w2, each a fused multiply-add), added, plus the
constant; K24 the first least NLL, K25 the responsibilities by logsumexp;
then the statistics: the frames of a tile (all of a staged fit, else
``tile`` frames of the ring) split over G groups (frame g, g + G, ...),
each group's sums of r (x - ref) and r (x - ref)^2, ref each mixture's
mean at the fit's start, summed plainly in blocks of 32 frames and the
blocks' sums added with Kahan's compensation, across tiles; the groups'
totals added as a pairwise tree.  The M-step of each kernel, and the next weights from
it (K25 through exp(log v)).  The fused multiply-add is the product in
float64 (exact for two float32 factors) and one rounding of the sum to
float32, so a result may differ from the card's in the last place; numpy's
exp and log are not the card's ``expf`` / ``logf`` either.  What the
emulation shows is the accuracy of the order of summation, and the
kernels' control flow: stops, empty clusters, the quirk, the last pass.
"""

import math

import numpy as np

THREADS = 256
SUM_BLOCK = 32
F32 = np.float32


def row_stride(d: int) -> int:
    """A staged row's floats: d rounded up to an odd number of float4s."""
    return 4 * (((d + 3) // 4) | 1)


def groups(m: int, d: int) -> int:
    """Frame groups a statistics owner (up to 4 mixtures, 4 dims) takes."""
    owners = -(-m // 4) * ((d + 3) // 4)
    return min(32, THREADS // owners) if owners <= THREADS else 1


def fma(a, b, c):
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def kahan(s, c, v, on):
    """``s += v`` with Kahan's compensation ``c``, where ``on``."""
    y = (v - c).astype(F32)
    t = (s + y).astype(F32)
    c_new = ((t - s).astype(F32) - y).astype(F32)
    return np.where(on, t, s), np.where(on, c_new, c)


def nlls(xq, w1, w2, wc):
    """``[n, M]`` NLLs of rows ``xq [n, Dq]`` (zero past D): the two
    chains over every column of the row stride, as the kernel's float4
    steps take them (a zero column adds nothing)."""
    n, dq = xq.shape
    m = w1.shape[0]
    a = np.zeros((n, m), F32)
    b = np.zeros((n, m), F32)
    x2 = (xq * xq).astype(F32)
    for d in range(dq):
        a = fma(x2[:, d:d + 1], w1[None, :, d], a)
        b = fma(xq[:, d:d + 1], w2[None, :, d], b)
    return ((a + b).astype(F32) + wc[None, :]).astype(F32)


def responsibilities(nll, lw):
    lp = (-nll + lw[None, :]).astype(F32)
    mx = lp.max(1)
    mx = np.where(np.isinf(mx), F32(0), mx).astype(F32)
    s = np.zeros(lp.shape[0], F32)
    for m in range(lp.shape[1]):
        s = (s + np.exp((lp[:, m] - mx).astype(F32))).astype(F32)
    lse = (np.log(s) + mx).astype(F32)
    return np.exp((lp - lse[:, None]).astype(F32)).astype(F32)


def statistics(xq, r, ref, g_count: int, tile):
    """The groups' totals ``(sum r (x - ref) [G, M, Dq], sum r (x -
    ref)^2, sum r [G, M])`` over the fit's rows ``xq`` with values ``r [n,
    M]``, ``ref [M, Dq]`` each mixture's mean at the fit's start (zero past
    D); ``tile`` None: one tile (a staged fit)."""
    n, dq = xq.shape
    m = r.shape[1]
    shape = (g_count, m, dq)
    s1, c1, s2, c2 = (np.zeros(shape, F32) for _ in range(4))
    sr, cr = np.zeros((g_count, m), F32), np.zeros((g_count, m), F32)
    g = np.arange(g_count)
    tiles = [(0, n)] if tile is None else [(j0, min(n, j0 + tile)) for j0 in range(0, n, tile)]
    for j0, j1 in tiles:
        nk = j1 - j0
        per = -(-nk // g_count)
        for b0 in range(0, per, SUM_BLOCK):
            b1, b2 = np.zeros(shape, F32), np.zeros(shape, F32)
            br = np.zeros((g_count, m), F32)
            for t in range(b0, min(per, b0 + SUM_BLOCK)):
                j = g + g_count * t
                ok = j < nk
                jj = j0 + np.minimum(j, nk - 1)
                xs = (xq[jj][:, None, :] - ref[None, :, :]).astype(F32)
                rr = r[jj][:, :, None]
                on = ok[:, None, None]
                b1 = np.where(on, fma(rr, xs, b1), b1)
                b2 = np.where(on, fma(rr, (xs * xs).astype(F32), b2), b2)
                br = np.where(ok[:, None], (br + r[jj]).astype(F32), br)
            started = (g + g_count * b0) < nk
            s1, c1 = kahan(s1, c1, b1, started[:, None, None])
            s2, c2 = kahan(s2, c2, b2, started[:, None, None])
            sr, cr = kahan(sr, cr, br, started[:, None])
    return s1, s2, sr


def group_sums(s1, s2, sr):
    """The groups' totals added as a pairwise tree over 32 slots (zero past
    G): (g0 + g1) + (g2 + g3), ..."""
    def tree(a):
        v = [a[g] for g in range(a.shape[0])] + [np.zeros_like(a[0])] * (32 - a.shape[0])
        while len(v) > 1:
            v = [(v[i] + v[i + 1]).astype(F32) for i in range(0, len(v), 2)]
        return v[0]

    return tree(s1), tree(s2), tree(sr)


def warp_sums(u, iv, lv, halves: int):
    """The constant's two sums over d as the M-step takes them: ``halves``
    warps a mixture, warp h's lane l adding d = 32 h + l, 32 h + l + 32
    halves, ... in order (u u iv contracted to a fused multiply-add), each
    warp's lanes by an xor tree, the second warp's sums added to the
    first's."""
    d = len(u)
    uu = (u * u).astype(F32)
    tot_s, tot_l = F32(0), F32(0)
    for h in range(halves):
        s, l = np.zeros(32, F32), np.zeros(32, F32)
        for lane in range(32):
            for i in range(32 * h + lane, d, 32 * halves):
                s[lane] = fma(uu[i], iv[i], s[lane])
                l[lane] = (l[lane] + lv[i]).astype(F32)
        for o in (16, 8, 4, 2, 1):
            s = (s + s[np.arange(32) ^ o]).astype(F32)
            l = (l + l[np.arange(32) ^ o]).astype(F32)
        tot_s = s[0] if h == 0 else F32(tot_s + s[0])
        tot_l = l[0] if h == 0 else F32(tot_l + l[0])
    return tot_s, tot_l


def weights(mu, var, d: int, round_trip: bool):
    """``(w1, w2 [M, Dq], wc [M])`` from the means and the variances the
    distances take."""
    m = mu.shape[0]
    dq = row_stride(d)
    v = var.astype(F32)
    if round_trip:
        v = np.exp(np.log(v)).astype(F32)
    lv = np.log(v).astype(F32)
    iv = np.exp(-lv).astype(F32)
    w1 = np.zeros((m, dq), F32)
    w2 = np.zeros((m, dq), F32)
    w1[:, :d] = (F32(0.5) * iv).astype(F32)
    w2[:, :d] = (-mu * iv).astype(F32)
    dlog2pi = F32(d * math.log(2.0 * math.pi))
    halves = 2 if 2 * m <= THREADS // 32 and d > 32 else 1
    wc = np.zeros(m, F32)
    for k in range(m):
        s, l = warp_sums(mu[k], iv[k], lv[k], halves)
        wc[k] = F32(0.5) * ((s + l).astype(F32) + dlog2pi)
    return w1, w2, wc


def _close(a, b, rtol, atol):
    return bool(np.all(np.abs(a - b) <= F32(atol) + F32(rtol) * np.abs(b)))


def _rows(x, mask):
    d = x.shape[1]
    xq = np.zeros((int(mask.sum()), row_stride(d)), F32)
    xq[:, :d] = x[mask]
    return xq


def _ref(mu, d: int):
    ref = np.zeros((mu.shape[0], row_stride(d)), F32)
    ref[:, :d] = mu
    return ref


def _tile(n_f: int, cap: int, tile: int):
    return None if n_f <= cap else tile


def kmeans_fit(x, mask, c0, k: int, init, cap: int, tile: int = 256, max_iters: int = 100,
               quirk: bool = False, var_floor: float = 1e-6):
    """K24 on one fit: ``(assign [N], centroids [k, D], variances [k, D],
    counts [k], iterations)``; ``cap`` the frames a CTA stages (the plan's)
    and ``tile`` the ring's tile."""
    x = np.asarray(x, F32)
    n, d = x.shape
    xq = _rows(x, mask)
    til = _tile(len(xq), cap, tile)
    g_count = groups(k, d)
    vf = F32(var_floor)
    mu = np.asarray(c0, F32).copy()
    start = mu.copy()
    # the first pass (a random assignment) about the start means' average
    avg = np.zeros(d, F32)
    for m in range(k):
        avg = (avg + start[m]).astype(F32)
    first_ref = _ref(np.broadcast_to((avg / F32(k)).astype(F32), start.shape), d)

    def update(assign_fit, ref=_ref(start, d)):
        r = (assign_fit[:, None] == np.arange(k)[None, :]).astype(F32)
        t1, t2, c = group_sums(*statistics(xq, r, ref, g_count, til))
        sh = (t1[:, :d] / np.maximum(c, F32(1))[:, None]).astype(F32)
        v = ((t2[:, :d] - ((c[:, None] * sh).astype(F32) * sh).astype(F32)).astype(F32)
             / np.maximum(c - F32(1), F32(1))[:, None]).astype(F32)
        return c, (start + sh).astype(F32), np.maximum(v, vf)

    counts, _, var = update(np.asarray(init)[mask], first_ref)
    var0 = var[0].copy()
    w = weights(mu, np.broadcast_to(var0, mu.shape) if quirk else var, d, False)
    it, last_w = 0, None
    while it < max_iters:
        assign_fit = np.argmin(nlls(xq, *w), axis=1)
        counts, mean, var = update(assign_fit)
        now = np.where(counts[:, None] > 0, mean, mu).astype(F32)
        done = _close(now, mu, 1e-5, 1e-8)
        mu, last_w = now, w
        w = weights(mu, np.broadcast_to(var0, mu.shape) if quirk else var, d, False)
        it += 1
        if done:
            break
    if it == 0:
        assign = np.asarray(init).copy()
    else:
        full = np.zeros((n, row_stride(d)), F32)
        full[:, :d] = x
        assign = np.argmin(nlls(full, *last_w), axis=1)
    out_var = np.broadcast_to(var0, mu.shape).copy() if quirk else var
    return assign, mu, out_var, counts, it


def em_fit(x, mask, m0, v0, w0, cap: int, tile: int = 256, max_iters: int = 100,
           rtol: float = 1e-5, atol: float = 1e-8, var_floor: float = 1e-6):
    """K25 on one fit: ``(means [M, D], variances [M, D], weights [M],
    iterations)``."""
    x = np.asarray(x, F32)
    d = x.shape[1]
    xq = _rows(x, mask)
    n_valid = F32(len(xq))
    til = _tile(len(xq), cap, tile)
    mu, var, wt = (np.asarray(a, F32).copy() for a in (m0, v0, w0))
    ref = _ref(mu, d)
    g_count = groups(mu.shape[0], d)
    vf = F32(var_floor)
    it = 0
    while it < max_iters:
        w = weights(mu, var, d, True)
        with np.errstate(divide="ignore"):  # a weight of 0: log w = -inf, as logf
            lw = np.log(wt).astype(F32)
        r = responsibilities(nlls(xq, *w), lw)
        t1, t2, c = group_sums(*statistics(xq, r, ref, g_count, til))
        den = np.maximum(c, F32(1e-10))
        k = (c / den).astype(F32)[:, None]  # 1 but where den is clamped
        sh = (t1[:, :d] / den[:, None]).astype(F32)
        r0 = ref[:, :d]
        mean = np.where(k == 1, r0 + sh, r0 * k + sh).astype(F32)
        q = (t2[:, :d] / den[:, None]).astype(F32)
        v = np.where(k == 1, q - (sh * sh).astype(F32),
                     q + r0 * (F32(2) * sh + r0 * k) - (mean * mean).astype(F32))
        v = np.maximum(v.astype(F32), vf)
        wn = (c / max(n_valid, F32(1e-10))).astype(F32)
        done = _close(mean, mu, rtol, atol) and _close(v, var, rtol, atol) and \
            _close(wn, wt, rtol, atol)
        mu, var, wt = mean, v, wn
        it += 1
        if done:
            break
    return mu, var, wt, it
