"""A Python emulation of the walk of kernel K5, the lexical-tree value
backtrace (``speech_recognition_tpu_torch/csrc/lex_backtrace.cu``), on
numpy planes.  The tests hold it state for state and flag for flag
against the plain version ``lex_backtrace_val_ref``;
``scripts/exp_r11_k5_windows.py`` counts its windows.

The walk follows the kernel's rules.  A window is F frames x the P states
of st's chain (``ops.viterbi_lex_kernels.lex_chains``: the states the walk
can reach backwards from st without an eps step, first state first, st at
position P - 1), F = min(t + 1, k_win / (P + 1)), with the eps_prev
entries of the chain's first state (slot ``heads[st, 1]``).  Each entry
(frame f, position q) of state s = chain[q] and code c stashes its step:
an eps code (4) leaves the chain for eps_prev[t - f, b, start_pos[s]] (the
window's column at q = 0); a cross code (3) goes to cross_src[s], a band
code d to s - d, and stays in the chain when that state is at position
q - 1 (cross) or q - d (band), as the next frame's entry index, else
leaves for it (a negative code, which K4 never writes, always leaves).  The walk records the state of each entry it visits and
follows the indices until it leaves the chain or the window ends.  While
it walks, the next window of the same chain is loaded; the walk takes it
when it ends inside the chain.
"""

import numpy as np

K_WIN = 256  # the kernel's kWin
CROSS, EPS = 3, 4


def walk(bp8, eps_prev, cross_src, start_pos, chains, heads, end_state, nf, k_win=K_WIN):
    """The kernel's walk over numpy planes ``bp8 [T, B, S]``, ``eps_prev
    [T, B, R]``, the graph's ``cross_src`` and ``start_pos`` and its chain
    table ``(chains, heads)``: ``(states [T, B], flags [T, B], waited,
    ahead, left)``, the last three summed over streams (``waited``: windows
    of a new chain; ``ahead``: windows loaded during a walk; ``left``: walks
    that left their chain by a band or cross step)."""
    t_len, b_len, _ = bp8.shape
    states = np.zeros((t_len, b_len), np.int64)
    flags = np.zeros((t_len, b_len), bool)
    waited = ahead_n = left = 0
    for b in range(b_len):
        n = min(max(int(nf[b]), 0), t_len)
        st = int(end_state[b])
        states[n:, b] = st
        t, ahead, p = n - 1, False, 0
        while t >= 0:
            if ahead:
                ahead_n += 1
            else:
                waited += 1
                n_pos, slot = (int(x) for x in heads[st])
                cst = [int(x) for x in chains[st, :n_pos]]
                p = n_pos - 1
            n_fr = min(t + 1, k_win // (n_pos + 1))
            lim = n_fr * n_pos
            step = [0] * lim
            for i in range(lim):
                f, q = divmod(i, n_pos)
                s, code = cst[q], int(bp8[t - f, b, cst[q]])
                if code == EPS:
                    r = slot if q == 0 else int(start_pos[s])
                    step[i] = ~int(eps_prev[t - f, b, r])
                    continue
                d = 1 if code == CROSS else min(code, 2)
                to = int(cross_src[s]) if code == CROSS else s - min(code, 2)
                stays = code >= 0 and 0 <= q - d < n_pos and cst[q - d] == to
                step[i] = i + n_pos - d if stays else ~to
            i, f = p, 0
            while True:
                states[t - f, b] = cst[i - f * n_pos]
                flags[t - f, b] = int(bp8[t - f, b, cst[i - f * n_pos]]) == EPS
                f += 1
                e = step[i]
                if e < 0 or e >= lim:
                    break
                i = e
            t -= f
            ahead = e >= 0 and t >= 0
            if e >= 0:
                p = e - lim
            else:
                st = ~e
                left += t >= 0 and int(bp8[t + 1, b, states[t + 1, b]]) != EPS
    return states, flags, waited, ahead_n, left


def graph_tables(g):
    """``(cross_src, start_pos)`` of a BandedGraph as numpy."""
    return g.cross_src.numpy(), g.start_pos.numpy()
