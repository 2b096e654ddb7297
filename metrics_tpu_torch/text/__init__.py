from metrics_tpu_torch.text.bert import BERTScore

__all__ = ["BERTScore"]
