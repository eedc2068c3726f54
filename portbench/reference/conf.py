"""The decoder's sizes under the name that callers outside the
benchmark's lookup import (`portbench.reference.decoder` holds them)."""
from portbench.reference.decoder import (  # noqa: F401
    MLA, VOCAB_PAD, Conf, MoE, from_json)
