"""A Python emulation of K26's window form, the token beam's walk
(``speech_recognition_tpu_torch/csrc/word_walk.cu``,
``token_walk_window_kernel``), on numpy arrays.  The tests hold it
against the plain walk ``ops.beam.beam_backtrace_ref``, where the kernel
itself cannot run.

It reads the planes only through the windows the kernel stages: the
lanes' best final slot is the least (cost key, slot); windows of ``W``
frames x k slots of ``tok_prev`` and ``tok_word`` are copied from the
last frame below the stream's length down into a ring of four, the
fourth ahead while the current is walked, and the walk reads only the
staged copies; a chain that dies stops the copies.  Returns the rows it
writes and the windows it copied a stream.
"""

import numpy as np

from speech_recognition_tpu_torch.ops import beam_kernels as bk
from tests.k19_beam import POS_INF, cost_key


def final_scores(final_state, final_cost, final_pred, tables, b, bigram_cost, bigram_end):
    """Each final slot's ``(score, word)`` of stream b, as ``final_score``."""
    end_slot, end_word = tables.end_slot.numpy(), tables.end_word.numpy()
    end_bonus = tables.end_bonus.numpy()
    s_len, e_len = tables.n_states, end_bonus.shape[0]
    out = []
    for j in range(final_state.shape[1]):
        s = int(final_state[b, j])
        sc = min(max(s, 0), s_len - 1)
        slot, word = int(end_slot[sc]), int(end_word[sc])
        bonus = end_bonus[min(max(slot, 0), e_len - 1)]
        if bigram_cost is not None:
            v = bigram_cost.shape[1]
            wc = min(max(word, 0), v - 1)
            bonus = np.float32(bonus + bigram_cost[min(max(int(final_pred[b, j]), 0), v), wc])
            if bigram_end is not None:
                bonus = np.float32(bonus + bigram_end[wc])
        tot = np.float32(final_cost[b, j] + bonus) if s >= 0 and slot >= 0 else POS_INF
        out.append((tot, word))
    return out


def walk(final_state, final_cost, tok_prev, tok_word, tables, n_frames, window,
         final_pred=None, bigram_cost=None, bigram_end=None):
    """K26's window form on numpy arrays: ``(best_cost [B], words_rev
    [B, T + 1], windows [B])``."""
    b_len, t_len, k = tok_prev.shape
    best_cost = np.zeros(b_len, np.float32)
    words = np.full((b_len, t_len + 1), -7, np.int32)  # every row must be written
    copies = np.zeros(b_len, np.int64)
    for b in range(b_len):
        scores = final_scores(final_state, final_cost, final_pred, tables, b, bigram_cost,
                              bigram_end)
        lanes = [min(((cost_key(tot) << 32) | j, j) for j, (tot, _) in enumerate(scores)
                     if j % 32 == lane) for lane in range(min(32, k))]
        _, ix = min(lanes)
        best_cost[b], words[b, 0] = scores[ix][0], scores[ix][1]
        n = min(max(int(n_frames[b]), 0), t_len)
        words[b, 1:t_len - n + 1] = -1
        if n == 0:
            continue
        n_win = -(-n // window)

        def copy(i):  # window i: frames [max(0, n - (i + 1) W), n - 1 - i W]
            hi_, lo_ = n - 1 - i * window, max(0, n - (i + 1) * window)
            return tok_prev[b, lo_:hi_ + 1].copy(), tok_word[b, lo_:hi_ + 1].copy()

        ring = {i: copy(i) for i in range(min(bk.WALK_STAGES, n_win))}
        lo = n
        for i in range(n_win):
            hi, lo = n - 1 - i * window, max(0, n - (i + 1) * window)
            prev_w, word_w = ring.pop(i)
            for t in range(hi, lo - 1, -1):
                w = -1
                if ix >= 0:
                    w = int(word_w[t - lo, ix])
                    if t > 0:
                        ix = int(prev_w[t - lo, ix])
                words[b, t_len - t] = w
            if ix < 0:
                break
            if i + bk.WALK_STAGES < n_win:
                ring[i + bk.WALK_STAGES] = copy(i + bk.WALK_STAGES)
        copies[b] = min(n_win, i + bk.WALK_STAGES)
        words[b, t_len - lo + 1:] = -1
    assert (words != -7).all()
    return best_cost, words, copies
