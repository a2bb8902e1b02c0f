"""Token selection for the port's serving engine — the port of
``skypilot_tpu/serve/sampling/``. A request's sampled tokens are a pure
function of its own ``(seed, position)`` pairs (batch invariance):

- ``prng``: counter-based per-row keys, JAX's threefry2x32 bit for bit;
- ``sample``: per-row temperature/top-p sampling in the device steps
  (``temperature <= 0`` rows reduce bitwise to the argmax) and the
  grammar-mask gather;
- ``accept``: the one speculative acceptance rule (maximal coupling, so
  spec-on output is spec-off output);
- ``grammar``: host-side structured decoding (regex / JSON schema to a
  character DFA to per-state token masks).
"""
from skypilot_torch.serve.sampling.accept import accept_tokens
from skypilot_torch.serve.sampling.grammar import (CompiledGrammar,
                                                   GrammarError,
                                                   compile_grammar,
                                                   grammar_hash)
from skypilot_torch.serve.sampling.prng import row_key, row_keys
from skypilot_torch.serve.sampling.sample import (gather_masks,
                                                  sample_first,
                                                  sample_rows,
                                                  verify_targets)

__all__ = [
    'accept_tokens', 'CompiledGrammar', 'GrammarError',
    'compile_grammar', 'grammar_hash', 'row_key', 'row_keys',
    'gather_masks', 'sample_first', 'sample_rows', 'verify_targets',
]
