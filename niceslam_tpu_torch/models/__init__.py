from .decoders import (  # noqa: F401
    DecoderConfig,
    init_decoders,
    nice_forward,
    decoder_param_labels,
)
