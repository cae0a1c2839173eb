"""paddle.text (counterpart of paddle_tpu/text/__init__.py):
`viterbi_decode` and `ViterbiDecoder` over `viterbi_decode_op`
(ops/misc_ops.py). The datasets (`Imdb`, `WMT14`, ...) are not ported
yet (ROADMAP.md)."""
from ..ops.misc_ops import viterbi_decode as _viterbi_op

__all__ = ["viterbi_decode", "ViterbiDecoder"]


def viterbi_decode(potentials, transition_params, lengths,
                   include_bos_eos_tag=True, name=None):
    """(scores [B], paths [B, max(lengths)] int64) of the best tag paths
    (reference: text/viterbi_decode.py:23)."""
    return _viterbi_op(potentials, transition_params, lengths,
                       include_bos_eos_tag=bool(include_bos_eos_tag))


class ViterbiDecoder:
    """viterbi_decode with its transitions held: call(potentials,
    lengths)."""

    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        self.transitions = transitions
        self.include_bos_eos_tag = include_bos_eos_tag

    def __call__(self, potentials, lengths):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)
