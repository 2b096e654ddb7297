"""Text module metrics (counterpart of ``metrics_tpu/text/``)."""
from metrics_tpu_torch.text.bert import BERTScore
from metrics_tpu_torch.text.bleu import BLEUScore, SacreBLEUScore
from metrics_tpu_torch.text.chrf import CHRFScore
from metrics_tpu_torch.text.eed import ExtendedEditDistance
from metrics_tpu_torch.text.error_rates import (
    CharErrorRate,
    MatchErrorRate,
    WordErrorRate,
    WordInfoLost,
    WordInfoPreserved,
)
from metrics_tpu_torch.text.rouge import ROUGEScore
from metrics_tpu_torch.text.squad import SQuAD
from metrics_tpu_torch.text.ter import TranslationEditRate

__all__ = [
    "BERTScore", "BLEUScore", "CHRFScore", "CharErrorRate", "ExtendedEditDistance", "MatchErrorRate", "ROUGEScore",
    "SQuAD", "SacreBLEUScore", "TranslationEditRate", "WordErrorRate", "WordInfoLost", "WordInfoPreserved",
]
