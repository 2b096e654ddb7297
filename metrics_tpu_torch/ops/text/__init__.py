"""Text functional metrics (counterpart of ``metrics_tpu/ops/text/``)."""
from metrics_tpu_torch.ops.text.bert import bert_score
from metrics_tpu_torch.ops.text.bleu import bleu_score
from metrics_tpu_torch.ops.text.chrf import chrf_score
from metrics_tpu_torch.ops.text.eed import extended_edit_distance
from metrics_tpu_torch.ops.text.error_rates import (
    char_error_rate,
    match_error_rate,
    word_error_rate,
    word_information_lost,
    word_information_preserved,
)
from metrics_tpu_torch.ops.text.rouge import rouge_score
from metrics_tpu_torch.ops.text.sacre_bleu import sacre_bleu_score
from metrics_tpu_torch.ops.text.squad import squad
from metrics_tpu_torch.ops.text.ter import translation_edit_rate

__all__ = [
    "bert_score", "bleu_score", "char_error_rate", "chrf_score", "extended_edit_distance", "match_error_rate",
    "rouge_score", "sacre_bleu_score", "squad", "translation_edit_rate", "word_error_rate",
    "word_information_lost", "word_information_preserved",
]
