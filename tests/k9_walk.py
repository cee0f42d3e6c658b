"""A Python emulation of the walk of kernel K9, the general backtrace
(``speech_recognition_tpu_torch/csrc/banded_backtrace.cu``), on numpy
planes.  The tests hold it state for state and flag for flag against the
plain version ``banded_backtrace_tb`` and the reference's Pallas
backtrace; ``scripts/exp_r10_k9_windows.py`` counts its windows.

The walk follows the kernel's rules.  A window is F frames x the states
[lo, hi = st], F = min(t + 1, 128 / (hi - lo + 2)); lo is a hint, the
last word start at or below st, at most 31 below; with the window come
the word's eps_u entries (slot start_pos[lo]).  At frame t the state
before any unwind is recorded; while the code is the eps code (4) and
fewer than eps_depth unwinds ran, st moves to word_ends[eps_u[t,
start_pos[st], b]] and the code is re-read at the same frame (a new
window once st leaves [lo, hi]); then st steps to st - code for t > 0,
or to cross_src[st] for the cross code (3) of a graph with cross edges
(st - 4 if the eps code is left after eps_depth unwinds).  On such a
graph the hint also takes the arc starts (the targets of finite cross
edges).  While the
walk runs, the next window of the same word and span is loaded (used when
the walk ends inside [lo, hi] with the window used up), and, where the
window has an eps code at lo, the window of the word the first such
unwind lands in, at that frame (used when the walk unwinds there).
"""

import numpy as np

K_WIN = 128  # the kernel's kWin
CROSS = 3    # the cross code
EPS = 4      # the eps code


def word_hint(st, is_start):
    """The kernel's lo: the last word start at or below ``st``, at most
    31 below, else ``max(st - 31, 0)``."""
    for d in range(32):
        if st - d >= 0 and is_start[st - d]:
            return st - d
    return max(st - 31, 0)


def walk(bp8, eps_u, start_pos, word_ends, is_start, end_state, nf, eps_depth,
         cross_src=None):
    """The kernel's walk over numpy planes ``bp8 [T, S, B]``, ``eps_u [T,
    R, B]`` and the graph's ``start_pos``, ``word_ends``, span hint
    ``is_start`` (``graph_tables``) and ``cross_src`` (None: no cross
    edges): ``(states [T, B], flags [T, B], waited, ahead, unwinds)``, the
    last three summed over streams (``ahead``: windows loaded during a
    walk, of the same span or of a word change)."""
    t_len, _, b_len = bp8.shape
    n_ends = len(word_ends)
    states = np.zeros((t_len, b_len), np.int64)
    flags = np.zeros((t_len, b_len), bool)
    waited = ahead_n = unwinds = 0

    def end_of(u):
        return int(word_ends[u]) if 0 <= u < n_ends else 0

    for b in range(b_len):
        n = min(max(int(nf[b]), 0), t_len)
        st = int(end_state[b])
        states[n:, b] = st
        rec, k, used = st, 0, False
        t, ahead, spec = n - 1, False, None
        lo = hi = r0 = 0
        while t >= 0:
            if ahead or spec == (st, t):
                ahead_n += 1
            else:
                waited += 1
            if not ahead:
                hi, lo = st, word_hint(st, is_start)
                r0 = int(start_pos[lo])
            nfr = min(t + 1, K_WIN // (hi - lo + 2))
            eps_at_lo = [f for f in range(nfr) if int(bp8[t - f, lo, b]) == EPS]
            spec = None
            if eps_at_lo:  # the word the window's first unwind at lo lands in
                spec = (end_of(int(eps_u[t - eps_at_lo[0], r0, b])), t - eps_at_lo[0])
            f = 0
            while f < nfr:
                tt = t - f
                code = int(bp8[tt, st, b])
                if code == EPS and k < eps_depth:  # unwind, re-read at the same frame
                    k, used = k + 1, True
                    unwinds += 1
                    slot = r0 if st == lo else int(start_pos[st])
                    st = end_of(int(eps_u[tt, slot, b]))
                    if st < lo or st > hi:
                        break  # another word: a new window at this frame
                    continue
                states[tt, b], flags[tt, b] = rec, used
                if tt > 0:
                    st = (int(cross_src[st]) if code == CROSS and cross_src is not None
                          else st - code)
                f += 1
                rec, k, used = st, 0, False
                if st < lo or st > hi:
                    break
            ahead = f == nfr and t - nfr >= 0 and lo <= st <= hi
            t -= f
    return states, flags, waited, ahead_n, unwinds


def graph_tables(g):
    """``(start_pos, word_ends, span hint)`` of a BandedGraph as numpy: the
    hint the kernel's wrapper passes (word starts, and on a graph with
    cross edges the targets of finite ones)."""
    hint = g.is_start.numpy()
    if g.cross_src is not None:
        hint = hint | (g.cross_cost.numpy() < 1e30 / 2)
    return g.start_pos.numpy(), g.word_ends.numpy(), hint
