"""A Python emulation of kernel K19, the token beam's frame loop
(``speech_recognition_tpu_torch/csrc/token_beam.cu``), on numpy arrays.
The tests hold it against the plain version ``ops.beam.beam_search_ref``
on live slots, where the kernel itself cannot run.

It follows the kernel's steps and keys, not the plain version's sorts,
and reads the graph only through the packed tables
(``ops.beam_kernels.beam_pack``):

* each frontier token proposes its run of edge records (target, weight,
  target's bank row); a live candidate (cost < POS_INF / 2 after the
  emission add and the clamp) goes into a per-state key table as
  ``cost_key(cost) << 32 | origin state``, the least key kept (the
  kernel's 64-bit atomicMin), and the first proposal lists the state;
* the survivors' keys ``cost_key << 32 | state`` are cut into runs of 32,
  each sorted (a warp's shuffle network); each round merges groups of up
  to 8 runs, a real key's place being its index plus, in each other run
  of its group, the count of keys below it by the kernel's branchless
  binary search, places at or past k dropped and the rest of each run
  padding; the first k of the last run form M, each with its origin
  token's index and predecessor and its state record, and the key table
  entry of its state marks M's index;
* each word start takes the end token of M of least ``(cost_key(eps +
  (cost + bigram)) << 32 | slot)``;
* an eps candidate replaces M's token of its state (found through the key
  table) only at a strictly lower cost, the first of equal eps candidates
  of one state wins (a pass of its own where word starts share a state),
  and every survivor's rank is counted against the winners' keys.

The orders the kernel's atomics leave free (the touched list, the end
list, the winners) are shuffled by ``seed``: no result may depend on
them.  Dead slots are -1 (final cost POS_INF), as the kernel writes them.
"""

import numpy as np

from speech_recognition_tpu_torch.ops import beam_kernels as bk

POS_INF = np.float32(1e30)
HALF = np.float32(POS_INF * np.float32(0.5))
EMPTY = (1 << 64) - 1
LOW = (1 << 32) - 1
HIGH = EMPTY ^ LOW
IN_M = 1 << 31


def cost_key(x) -> int:
    """The kernel's ``cost_key``: unsigned order is float order; -0 is +0."""
    u = int(np.array([np.float32(x) + np.float32(0.0)], np.float32).view(np.uint32)[0])
    return (~u & LOW) if u & 0x80000000 else (u | 0x80000000)


def key_cost(k: int) -> np.float32:
    u = (k & 0x7FFFFFFF) if k & 0x80000000 else (~k & LOW)
    return np.array([u], np.uint32).view(np.float32)[0]


def _f(bits) -> np.float32:
    return np.array([bits], np.int32).view(np.float32)[0]


def _np(t):
    return t.cpu().numpy()


def merge_rule(state, cost, tie, k):
    """The selection rule on one row of candidates: each state's survivor
    is its candidate of least (cost, tie, position); the live survivors
    (cost < POS_INF / 2) of least (cost, state) are kept, at most k.
    Returns the kept candidates' positions in rank order."""
    best = {}
    for pos, (s, c, ti) in enumerate(zip(state, cost, tie)):
        key = (cost_key(c), int(ti), pos)
        if not np.float32(c) < HALF:
            continue
        if s not in best or key < best[s]:
            best[s] = key
    ranked = sorted(best.items(), key=lambda it: (it[1][0], it[0]))
    return [key[2] for _, key in ranked[:k]]


def count_below(run, x) -> int:
    """The kernel's branchless binary search: the count of keys of the
    sorted ``run`` below ``x``."""
    top = 1
    while 2 * top <= len(run):
        top <<= 1
    at, step = 0, top
    while step:
        c = at + step
        at = c if c <= len(run) and run[min(c, len(run)) - 1] < x else at
        step >>= 1
    return at


def rank_survivors(keys, k, cap):
    """The kernel's ranking of the survivors' keys (any order): runs of 32,
    each sorted (one run is all); rounds merging up to 8 runs, a real key's
    place in its group's run being its index plus its count in each other
    run of the group, places at or past k dropped, the rest of each run
    padding.  Returns the last run (M's keys first) and the merge rounds it
    took; the runs never outgrow ``cap`` (the kernel's buffers)."""
    keys = list(keys) + [EMPTY] * (-len(keys) % bk.RUN)
    runs = [sorted(keys[i:i + bk.RUN]) for i in range(0, len(keys), bk.RUN)]
    assert len(keys) <= cap
    rounds, length = 0, bk.RUN
    while len(runs) > 1:
        n = len(runs)
        g = min(n, bk.GROUP)
        n_out = -(-n // g)
        len_out = min(g * length, k)
        out = [[EMPTY] * len_out for _ in range(n_out)]
        placed = set()
        for a, run in enumerate(runs):
            g0 = a - a % g
            for i, x in enumerate(run):
                if x == EMPTY or i >= len_out:
                    continue
                pos = i + sum(count_below(runs[o], x) for o in range(g0, min(g0 + g, n))
                              if o != a)
                if pos < len_out:
                    assert (a // g, pos) not in placed
                    placed.add((a // g, pos))
                    out[a // g][pos] = x
        assert n_out * len_out <= cap
        runs, length, rounds = out, len_out, rounds + 1
    return (runs[0] if runs else []), rounds


def beam(nll, tables, n_frames, k, has_cross=True, bigram_cost=None, seed=0, stats=None):
    """K19 on ``nll [B, T, U]`` (numpy float32) with the port's
    ``BeamTables``: ``(final_state, final_cost, final_pred, tok_state,
    tok_prev, tok_word)`` as the kernel writes them.  ``stats``, a list,
    gets each frame's ``(survivors, rounds)``."""
    pack = bk.beam_pack(tables, has_cross)
    r0 = tables.init_states.shape[0]
    mmax = bk.beam_widest(pack, k, r0)
    cap = bk._sort_cap(mmax, k)
    rng = np.random.default_rng(seed)
    eps_block = _np(tables.eps_block)
    big = None if bigram_cost is None else np.asarray(bigram_cost, np.float32)
    v = 0 if big is None else big.shape[1]
    b_len, t_len, _ = nll.shape
    r_len = eps_block.shape[0]
    fst = np.full((b_len, k), -1, np.int32)
    fco = np.full((b_len, k), POS_INF, np.float32)
    fpd = np.full((b_len, k), -1, np.int32)
    planes = [np.full((b_len, t_len, k), -1, np.int32) for _ in range(3)]
    for b in range(b_len):
        nfb = int(n_frames[b])
        t_end = max(1, min(nfb, t_len))
        front = []  # (state, cost, pred, first edge, edge count) in rank order
        tokidx = {}
        for t in range(t_end):
            row = nll[b, t]
            key, touched = {}, []

            def propose(tgt, val, origin):
                if val < HALF:
                    new = (cost_key(val) << 32) | origin
                    if tgt not in key:
                        touched.append(tgt)
                    key[tgt] = min(key.get(tgt, EMPTY), new)

            if t == 0:
                for s, c, bank, _ in pack.init[:r0]:
                    propose(int(s), min(np.float32(_f(c) + row[bank]), POS_INF), int(s))
            else:
                for s, c, _, off, cnt in front:
                    for tgt, w, bank, _ in pack.edges[off:off + cnt]:
                        propose(int(tgt), min(np.float32(np.float32(c + _f(w)) + row[bank]),
                                              POS_INF), s)
            rng.shuffle(touched)  # the order the kernel's atomics list the states in
            m = len(touched)
            assert m <= mmax
            n1 = min(m, k)
            last, rounds = rank_survivors([(key[s] & HIGH) | s for s in touched], k, cap)
            if stats is not None:
                stats.append((m, rounds))
            merged, ends = [], []  # M: (key, state, cost, prev, pred, slot, word, off, cnt)
            for i, x in enumerate(last[:n1]):
                s = x & LOW
                full = key[s]
                prev, pred = -1, v
                if t > 0:
                    prev = tokidx[full & LOW]
                    pred = front[prev][2]
                off, cnt, slot, word = (int(q) for q in pack.rec[s])
                merged.append((x, s, key_cost(x >> 32), prev, pred, slot, word, off, cnt))
                key[s] = (full & HIGH) | IN_M | i
                if slot >= 0:
                    ends.append(i)
            rng.shuffle(ends)
            eps = [None] * r_len  # (state, cost, prev, word, pred, off, cnt)
            for r in range(r_len):
                st, bank, off, cnt = (int(q) for q in pack.starts[r])
                best, bi = EMPTY, -1
                for i in ends:
                    _, _, c, _, pr, slot, w, _, _ = merged[i]
                    ex = c
                    if big is not None:
                        bg = big[min(max(pr, 0), v), min(max(w, 0), v - 1)] if w >= 0 \
                            else POS_INF
                        ex = np.float32(c + bg)
                    score = np.float32(eps_block[r, slot] + ex)
                    kk = (cost_key(score) << 32) | slot
                    if kk < best:
                        best, bi = kk, i
                if best != EMPTY:
                    val = min(np.float32(key_cost(best >> 32) + row[bank]), POS_INF)
                    if val < HALF:
                        w = merged[bi][6]
                        eps[r] = (st, val, merged[bi][3], w, w if big is not None else v, off,
                                  cnt)
            # the second merge: winners, each with the index in M it replaces
            winners = []
            for r, e in enumerate(eps):
                if e is None:
                    continue
                if pack.dup_starts and any(
                        e2 is not None and r2 != r and e2[0] == e[0]
                        and (e2[1] < e[1] or (e2[1] == e[1] and r2 < r))
                        for r2, e2 in enumerate(eps)):
                    continue
                kv, kill = key.get(e[0], EMPTY), -1
                if kv != EMPTY and kv & IN_M:
                    kill = (kv & LOW) ^ IN_M
                    if not e[1] < merged[kill][2]:
                        continue
                winners.append((r, kill))
            rng.shuffle(winners)
            wkey = {r: (cost_key(eps[r][1]) << 32) | eps[r][0] for r, _ in winners}
            n_kill = sum(kill >= 0 for _, kill in winners)
            n_new = min(k, n1 - n_kill + len(winners))
            new_front = [None] * n_new
            for q, (x, s, c, prev, pred, _, _, off, cnt) in enumerate(merged):
                if any(kill == q for _, kill in winners):
                    continue
                rank = q - sum(0 <= kill < q for _, kill in winners) + sum(
                    wkey[r] < x for r, _ in winners)
                if rank < k:
                    new_front[rank] = (s, c, pred, off, cnt, prev, -1)
            mkeys = [m_[0] for m_ in merged]
            for r, _ in winners:
                x = wkey[r]
                lo = int(np.searchsorted(np.array(mkeys, np.uint64), np.uint64(x)))
                rank = lo - sum(0 <= kill < lo for _, kill in winners) + sum(
                    r2 != r and wkey[r2] < x for r2, _ in winners)
                if rank < k:
                    st, c, prev, w, pred, off, cnt = eps[r]
                    new_front[rank] = (st, c, pred, off, cnt, prev, w)
            assert all(x is not None for x in new_front)
            front = [x[:5] for x in new_front]
            tokidx = {x[0]: j for j, x in enumerate(front)}
            for j, (s, _, _, _, _, prev, w) in enumerate(new_front):
                planes[0][b, t, j], planes[1][b, t, j], planes[2][b, t, j] = s, prev, w
        if 1 <= nfb <= t_len:
            for j, (s, c, pred, _, _) in enumerate(front):
                fst[b, j], fco[b, j], fpd[b, j] = s, c, pred
    return (fst, fco, fpd, *planes)
