"""THE single speculative-acceptance implementation of the port — the
counterpart of ``skypilot_tpu/serve/sampling/accept.py``.

The engine's n-gram drafter is deterministic (a point-mass proposal
at the draft d), so the speculative-sampling rule of Chen et al.
(2023) specializes to maximal coupling against the target model's
realization x* at each position: accept d iff d == x*, and emit x*
always. For greedy rows x* is the argmax, and the rule is the leading
run of drafts equal to the argmax — spec-on output is token-for-token
spec-off output.

``accept_tokens`` is lint-enforced as the ONE acceptance
implementation in ``skypilot_torch/`` (tests/test_torch_batching.py):
any other draft-vs-target comparison would be a second acceptance
path the exactness tests do not cover.
"""
import torch


def accept_tokens(tokens: torch.Tensor, preds: torch.Tensor,
                  n_real: torch.Tensor) -> torch.Tensor:
    """Per-row count of accepted draft tokens.

    ``tokens`` [B, W]: column 0 is the row's committed last token,
    columns 1.. are the drafts. ``preds`` [B, W]: the target-model
    realizations x* per position (the argmax for greedy rows).
    ``n_real`` [B]: 1 + number of real drafts (0 = parked row).

    Row r accepts the longest leading run of drafts whose token
    equals the target realization at its position. The engine rolls
    back everything after the first mismatch; the emitted tokens are
    ``preds[r, :accepted+1]``.
    """
    w = tokens.shape[1]
    ok = tokens[:, 1:] == preds[:, :-1]
    is_draft = (torch.arange(w - 1, dtype=torch.int32,
                             device=tokens.device)[None, :]
                < (n_real - 1)[:, None])
    lead = torch.cumprod((ok & is_draft).to(torch.int32), dim=1)
    return lead.sum(dim=1).to(torch.int32)
