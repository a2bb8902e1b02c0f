"""Token selection for the port's serving engine. Greedy only in this
slice: ``accept_tokens`` is the speculative acceptance rule; sampled
decode and grammar masks come with the sampling slice (ROADMAP.md)."""
from skypilot_torch.serve.sampling.accept import accept_tokens

__all__ = ['accept_tokens']
