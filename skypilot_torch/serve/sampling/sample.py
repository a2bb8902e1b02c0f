"""Per-row sampled decode inside the engine's device steps — the port
of ``skypilot_tpu/serve/sampling/sample.py``.

All knobs are per-row tensors — temperature [B], top_p [B], seed [B] —
so one step serves every request mix; greedy rows ride along with
``temperature == 0`` and reduce bitwise to the argmax. Randomness comes
only from the counter keys of ``prng`` (one draw per ``(seed,
position)``), and every operation here is row-wise, with no reduction
across rows: a row's draw is a function of its own logits, knobs, seed
and position (batch invariance).

Grammar masks arrive as a ``[M, V]`` bool table plus per-row indices
and are gathered on the device (``gather_masks``): row 0 of the table
is the all-allowed mask, so unconstrained rows share index 0.

The JAX package has no Pallas kernel here. The top-p filter is a
row-wise sort, then the nucleus threshold (``ops/top_p.top_p_kth``: on
the card a kernel whose sums run in an order set by the row length, so
a row's cut does not move with the batch); the keys and noise are
elementwise threefry.
"""
from typing import Optional

import torch

from skypilot_torch.ops import top_p as top_p_ops
from skypilot_torch.serve.sampling import prng

# The engine's NEG_INF (finite: arithmetic on it stays NaN-free through
# softmax and cumsum).
NEG_INF = -1e30


def gather_masks(mask_table: torch.Tensor,
                 mask_idx: torch.Tensor) -> torch.Tensor:
    """Per-row [B, ...] allowed-token masks gathered out of a [M, ...]
    table by per-row index (built host-side by the grammar walker)."""
    return mask_table.index_select(0, mask_idx.long())


def _filter_top_p_row(logits: torch.Tensor,
                      top_p: torch.Tensor) -> torch.Tensor:
    """Nucleus filter of each row of ``logits`` [N, V] at its own
    ``top_p`` [N], as ``models/decode._filter_top_p``: keep the
    smallest descending-probability prefix whose cumulative mass
    reaches top_p (ties at the cut kept); the top-1 token is always
    kept (top_p is clamped above 0)."""
    top_p = torch.clamp_min(top_p.float(), 1e-6)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    kth = top_p_ops.top_p_kth(sorted_desc, top_p)
    return torch.where(logits < kth, NEG_INF, logits)


def _sample_row(logits: torch.Tensor, temperature: torch.Tensor,
                top_p: torch.Tensor, seed: torch.Tensor,
                position: torch.Tensor,
                allowed: Optional[torch.Tensor]) -> torch.Tensor:
    """Rows of ``logits`` [N, V] with their knobs [N]: the greedy argmax
    where ``temperature <= 0`` (bitwise the greedy engine), else the
    top-p + temperature categorical keyed (seed, position). Returns
    int32 [N]."""
    logits = logits.float()
    if allowed is not None:
        logits = torch.where(allowed, logits, NEG_INF)
    greedy = logits.argmax(dim=-1)
    filtered = _filter_top_p_row(logits, top_p)
    t_safe = torch.clamp_min(temperature.float(), 1e-6)
    keys = prng.row_keys(seed, position)
    sampled = prng.categorical(keys, filtered / t_safe[:, None])
    return torch.where(temperature <= 0.0, greedy,
                       sampled).to(torch.int32)


def sample_rows(logits: torch.Tensor, temperatures: torch.Tensor,
                top_ps: torch.Tensor, seeds: torch.Tensor,
                positions: torch.Tensor,
                allowed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row next-token selection for the decode steps. ``logits``
    [B, V]; ``temperatures``/``top_ps``/``seeds``/``positions`` [B];
    ``allowed`` optional [B, V] bool. Returns int32 [B]."""
    return _sample_row(logits, temperatures, top_ps, seeds, positions,
                       allowed)


def sample_first(logits: torch.Tensor, temperature, top_p, seed,
                 position,
                 allowed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """First-token selection from prefill logits [1, V], keyed as decode
    at the same absolute position (the prompt/decode boundary is
    invisible to the (seed, position) contract). Scalar knobs;
    ``allowed`` optional [V]. Returns an int32 scalar tensor."""
    dev = logits.device

    def one(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev).reshape(1)
    return _sample_row(
        logits[:1], one(temperature, torch.float32),
        one(top_p, torch.float32), one(seed, torch.int64),
        one(position, torch.int64),
        None if allowed is None else allowed[None])[0]


def verify_targets(logits: torch.Tensor, temperatures: torch.Tensor,
                   top_ps: torch.Tensor, seeds: torch.Tensor,
                   pos: torch.Tensor,
                   allowed: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Target-model token realizations for the verify step. ``logits``
    [B, W, V]: row r's column j holds the logits at absolute position
    ``pos[r] + j``, and draws with the key plain decode would use there
    — so the realized token is exactly the token plain sampled decode
    would emit (the maximal-coupling half of ``accept.py``'s rule).
    ``allowed`` optional [B, W, V] (per-position grammar masks walked
    host-side along the draft path). Returns int32 [B, W]."""
    b, w, v = logits.shape
    positions = pos[:, None].long() + torch.arange(
        w, dtype=torch.int64, device=pos.device)[None, :]

    def per_col(x):
        return x[:, None].expand(b, w).reshape(-1)
    return _sample_row(
        logits.reshape(b * w, v), per_col(temperatures),
        per_col(top_ps), per_col(seeds), positions.reshape(-1),
        None if allowed is None else allowed.reshape(b * w, v)
    ).reshape(b, w)
