from dicttts_tpu_torch.vocoders.base_vocoder import BaseVocoder, get_vocoder_cls, register_vocoder  # noqa: F401
from dicttts_tpu_torch.vocoders.hifigan import HifiGanVocoder  # noqa: F401
