"""CTC loss (reference: ``src/operator/contrib/ctc_loss-inl.h``).

PyTorch counterpart of ``mxnet_tpu/ops/ctc.py``: the log-space forward
(alpha) recursion over time, differentiated by autograd (the JAX package
differentiates its ``lax.scan`` the same way instead of the reference's
hand-written beta recursion). Blank label 0; labels are padded with 0.
"""

from __future__ import annotations

import torch

from .registry import register

_NEG_INF = -1e30


@register("_ctc_loss", aliases=("ctc_loss", "CTCLoss"))
def ctc_loss(pred, label, pred_lengths=None, label_lengths=None):
    """pred: (T, N, C) raw activations; label: (N, L) integers, 0 = blank
    padding; lengths default to T and to the count of non-zero labels.
    Returns the per-example negative log likelihood, shape (N,).

    As in the JAX package, a sequence's final probability is the
    log-sum of alpha at its last two extended positions, so an empty
    label sequence (one extended position) counts that position twice."""
    T, N, _ = pred.shape
    dev = pred.device
    logp = torch.log_softmax(pred, dim=-1)
    label = label.long()
    label_len = (label != 0).sum(dim=1) if label_lengths is None \
        else label_lengths.long()
    pred_len = torch.full((N,), T, dtype=torch.long, device=dev) \
        if pred_lengths is None else pred_lengths.long()

    L = label.shape[1]
    S = 2 * L + 1
    ext = torch.zeros((N, S), dtype=torch.long, device=dev)
    ext[:, 1::2] = label  # blanks (0) interleaved
    ext_len = 2 * label_len + 1
    # alpha[s] may come from s - 2 when ext[s] is no blank and differs
    # from ext[s - 2]
    same_as_two_back = torch.cat(
        [torch.zeros((N, 2), dtype=torch.bool, device=dev),
         ext[:, 2:] == ext[:, :-2]], dim=1)[:, :S]
    can_skip = (ext != 0) & ~same_as_two_back

    def neg(width):
        return torch.full((N, width), _NEG_INF, dtype=logp.dtype,
                          device=dev)

    first = torch.gather(logp[0], 1, ext[:, :2])  # blank, first label
    alpha = torch.cat([first, neg(S - first.shape[1])], dim=1)
    for t in range(1, T):
        prev1 = torch.cat([neg(1), alpha[:, :-1]], dim=1)
        prev2 = torch.cat([neg(2), alpha[:, :-2]], dim=1)[:, :S]
        prev2 = torch.where(can_skip, prev2, _NEG_INF)
        merged = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
        new_alpha = merged + torch.gather(logp[t], 1, ext)
        # frozen past each example's input length
        alpha = torch.where((t < pred_len)[:, None], new_alpha, alpha)

    last = torch.gather(alpha, 1, (ext_len - 1)[:, None])[:, 0]
    second_last = torch.gather(
        alpha, 1, torch.clamp(ext_len - 2, min=0)[:, None])[:, 0]
    return -torch.logaddexp(last, second_last)
