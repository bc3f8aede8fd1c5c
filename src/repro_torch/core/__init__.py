"""Wharf core, ported: space-efficient streaming random walks.

Codes are 64-bit (Szudzik of two 32-bit operands, paper §4.3), held as
biased int64 (repro_torch/_u64.py).
"""
from repro_torch.core.pairing import (  # noqa: F401
    decode_triplet,
    encode_triplet,
    isqrt_u64,
    pack_wp,
    szudzik_pair,
    szudzik_unpair,
    unpack_wp,
)
from repro_torch.core.graph import StreamingGraph  # noqa: E402,F401
from repro_torch.core.store import WalkStore  # noqa: E402,F401
from repro_torch.core.corpus import (  # noqa: E402,F401
    WalkConfig,
    corpus_to_store,
    generate_corpus,
)
