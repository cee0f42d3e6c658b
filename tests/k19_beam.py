"""A Python emulation of kernel K19, the token beam's frame loop
(``speech_recognition_tpu_torch/csrc/token_beam.cu``), on numpy arrays.
The tests hold it against the plain version ``ops.beam.beam_search_ref``
on live slots, where the kernel itself cannot run.

It follows the kernel's steps and keys, not the plain version's sorts:

* a live candidate (cost < POS_INF / 2 after the emission add and the
  clamp) goes into a per-state key table as ``cost_key(cost) << 32 |
  origin state``, the least key kept (the kernel's 64-bit atomicMin);
* the survivors' keys ``cost_key << 32 | state`` are sorted and the
  first k form M, each with its origin token's index and predecessor;
* each word start takes the end token of M of least ``(cost_key(eps +
  (cost + bigram)) << 32 | slot)``;
* an eps candidate replaces M's token of its state only at a strictly
  lower cost, the first of equal eps candidates of one state wins, and
  every survivor's rank is counted against the others' keys.

Dead slots are -1 (final cost POS_INF), as the kernel writes them.
"""

import numpy as np

POS_INF = np.float32(1e30)
HALF = np.float32(POS_INF * np.float32(0.5))
EMPTY = (1 << 64) - 1
LOW = (1 << 32) - 1


def cost_key(x) -> int:
    """The kernel's ``cost_key``: unsigned order is float order; -0 is +0."""
    u = int(np.array([np.float32(x) + np.float32(0.0)], np.float32).view(np.uint32)[0])
    return (~u & LOW) if u & 0x80000000 else (u | 0x80000000)


def key_cost(k: int) -> np.float32:
    u = (k & 0x7FFFFFFF) if k & 0x80000000 else (~k & LOW)
    return np.array([u], np.uint32).view(np.float32)[0]


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


def beam(nll, tables, n_frames, k, has_cross=True, bigram_cost=None):
    """K19 on ``nll [B, T, U]`` (numpy float32) with the port's
    ``BeamTables``: ``(final_state, final_cost, final_pred, tok_state,
    tok_prev, tok_word)`` as the kernel writes them."""
    tb = {f: _np(getattr(tables, f)) for f in (
        "band", "child_starts", "child_costs", "end_slot", "end_word", "word_starts",
        "eps_block", "init_states", "init_costs", "bank_state")}
    big = None if bigram_cost is None else np.asarray(bigram_cost, np.float32)
    v = 0 if big is None else big.shape[1]
    b_len, t_len, _ = nll.shape
    s_len = tables.n_states
    n_child = tb["child_starts"].shape[1] if has_cross else 0
    nb = 3 + n_child
    r_len, _ = tb["eps_block"].shape
    fst = np.full((b_len, k), -1, np.int32)
    fco = np.full((b_len, k), POS_INF, np.float32)
    fpd = np.full((b_len, k), -1, np.int32)
    planes = [np.full((b_len, t_len, k), -1, np.int32) for _ in range(3)]
    for b in range(b_len):
        nfb = int(n_frames[b])
        t_end = max(1, min(nfb, t_len))
        front = []  # (state, cost, pred) in rank order
        tokidx = {}
        for t in range(t_end):
            row = nll[b, t]
            keys = {}

            def propose(tgt, val, origin):
                if val < HALF:
                    key = (cost_key(val) << 32) | origin
                    keys[tgt] = min(keys.get(tgt, EMPTY), key)

            def emis(s):
                return row[tb["bank_state"][s]]

            if t == 0:
                for s, c in zip(tb["init_states"], tb["init_costs"]):
                    propose(int(s), min(np.float32(c + emis(s)), POS_INF), int(s))
            else:
                for blk in range(nb):
                    for s, c, _ in front:
                        if blk < 3:
                            tgt = s + blk
                            if tgt >= s_len:
                                continue
                            w = tb["band"][blk, tgt]
                        else:
                            tgt = int(tb["child_starts"][s, blk - 3])
                            if tgt < 0:
                                continue
                            w = tb["child_costs"][s, blk - 3]
                        propose(tgt, min(np.float32(np.float32(c + w) + emis(tgt)), POS_INF),
                                s)
            ranked = sorted((keys[s] & ~LOW) | s for s in keys)
            n1 = min(len(ranked), k)
            merged = []  # (state, cost, prev, pred)
            for key in ranked[:n1]:
                s = key & LOW
                full = keys[s]
                prev, pred = -1, v
                if t > 0:
                    prev = tokidx[full & LOW]
                    pred = front[prev][2]
                merged.append((s, key_cost(full >> 32), prev, pred))
            at = {m[0]: i for i, m in enumerate(merged)}
            ends = [(i, int(tb["end_slot"][m[0]])) for i, m in enumerate(merged)
                    if tb["end_slot"][m[0]] >= 0]
            slot_at = {slot: i for i, slot in ends}
            eps = []  # (state, cost, prev, word, pred) or None
            for r in range(r_len):
                best = EMPTY
                for i, slot in ends:
                    s, c, _, pr = merged[i]
                    ex = c
                    if big is not None:
                        w = int(tb["end_word"][s])
                        bg = big[min(max(pr, 0), v), min(max(w, 0), v - 1)] if w >= 0 \
                            else POS_INF
                        ex = np.float32(c + bg)
                    score = np.float32(tb["eps_block"][r, slot] + ex)
                    best = min(best, (cost_key(score) << 32) | slot)
                cand = None
                if best != EMPTY:
                    i = slot_at[best & LOW]
                    st = int(tb["word_starts"][r])
                    val = min(np.float32(key_cost(best >> 32) + emis(st)), POS_INF)
                    if val < HALF:
                        w = int(tb["end_word"][merged[i][0]])
                        cand = (st, val, merged[i][2], w, w if big is not None else v)
                eps.append(cand)
            # the second merge
            kills, winners = set(), []
            for r, e in enumerate(eps):
                if e is None:
                    continue
                rivals = [r2 for r2, e2 in enumerate(eps) if r2 != r and e2 is not None
                          and e2[0] == e[0] and (e2[1] < e[1] or (e2[1] == e[1] and r2 < r))]
                if rivals:
                    continue
                i = at.get(e[0])
                if i is not None:
                    if not e[1] < merged[i][1]:
                        continue
                    kills.add(i)
                winners.append(e)
            out = [((cost_key(c) << 32) | s, s, c, prev, -1, pred)
                   for i, (s, c, prev, pred) in enumerate(merged) if i not in kills]
            out += [((cost_key(c) << 32) | s, s, c, prev, w, pred)
                    for s, c, prev, w, pred in winners]
            out = sorted(out)[:k]
            front = [(s, c, pred) for _, s, c, _, _, pred in out]
            tokidx = {s: j for j, (s, _, _) in enumerate(front)}
            for j, (_, s, _, prev, w, _) in enumerate(out):
                planes[0][b, t, j], planes[1][b, t, j], planes[2][b, t, j] = s, prev, w
        if 1 <= nfb <= t_len:
            for j, (s, c, pred) in enumerate(front):
                fst[b, j], fco[b, j], fpd[b, j] = s, c, pred
    return (fst, fco, fpd, *planes)
