from metrics_tpu_torch.ops.text.bert import bert_score

__all__ = ["bert_score"]
