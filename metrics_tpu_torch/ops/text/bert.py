"""BERTScore (Zhang et al. 2020): greedy cosine matching of contextual embeddings.

Counterpart of ``metrics_tpu/ops/text/bert.py``. The host tokenizes; the
encoder, the normalisation and masking (:func:`_finalize_embeddings`) and the
matching (:func:`_precision_recall_f1`, whose row and column maxima are the
``maxsim`` CUDA kernel) run on the device of ``device``.

Any PyTorch encoder can be plugged in through ``model``/``user_forward_fn``;
without ``model`` the default route loads a ``transformers`` checkpoint
(``AutoTokenizer`` and ``AutoModel``).
"""
from __future__ import annotations

import csv
import math
from collections import Counter, defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import resolve_device
from metrics_tpu_torch.ops.kernels.cosine_matching import pairwise_cosine_pr
from metrics_tpu_torch.utils.imports import _TRANSFORMERS_AVAILABLE
from metrics_tpu_torch.utils.prints import rank_zero_warn

_DEFAULT_MODEL = "roberta-large"


def _preprocess_text(
    text: List[str],
    tokenizer: Any,
    max_length: int = 512,
    truncation: bool = True,
) -> Dict[str, np.ndarray]:
    """Tokenize to fixed-width numpy ``input_ids``/``attention_mask``."""
    try:
        out = tokenizer(text, padding="max_length", max_length=max_length, truncation=truncation, return_tensors="np")
        return {"input_ids": np.asarray(out["input_ids"]), "attention_mask": np.asarray(out["attention_mask"])}
    except TypeError:
        # a user tokenizer without the transformers keywords owns the padded
        # width; padding it up to max_length would only add dead positions
        out = tokenizer(text)
        input_ids = np.asarray(out["input_ids"])
        attention_mask = np.asarray(out["attention_mask"])
        return {"input_ids": input_ids[:, :max_length], "attention_mask": attention_mask[:, :max_length]}


def _get_tokens_idf(input_ids: np.ndarray, attention_mask: np.ndarray) -> Dict[int, float]:
    """IDF over the reference corpus: log((N+1)/(df+1)); unseen -> log(N+1)."""
    num_sentences = input_ids.shape[0]
    counter: Counter = Counter()
    for ids, mask in zip(input_ids, attention_mask):
        counter.update(set(int(i) for i in ids[mask.astype(bool)]))
    tokens_idf: Dict[int, float] = defaultdict(lambda: math.log((num_sentences + 1) / 1))
    tokens_idf.update({idx: math.log((num_sentences + 1) / (occ + 1)) for idx, occ in counter.items()})
    return tokens_idf


def _process_attention_mask_for_special_tokens(attention_mask: Tensor) -> Tensor:
    """Zero out the first position and the last attended one (CLS and SEP)."""
    attention_mask = attention_mask.clone()
    attention_mask[:, 0] = 0
    sep_pos = torch.argmax(torch.cumsum(attention_mask - 0.1, dim=-1), dim=-1)
    attention_mask[torch.arange(attention_mask.shape[0], device=attention_mask.device), sep_pos] = 0
    return attention_mask


def _finalize_embeddings(out: Tensor, attention_mask: Tensor, token_idf: Tensor) -> Tuple[Tensor, Tensor]:
    """Guarded normalisation, special-token masking and idf scaling.

    The guarded norm keeps zero vectors (a model that embeds padding as 0)
    zero instead of NaN.
    """
    norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    out = out / torch.where(norm == 0, torch.ones((), dtype=norm.dtype, device=norm.device), norm)
    processed_mask = _process_attention_mask_for_special_tokens(attention_mask)
    out = out * processed_mask.to(out.dtype)[:, None, :, None]
    idf = token_idf * processed_mask
    idf = idf / idf.sum(dim=-1, keepdim=True)
    return out, idf


def _embed_and_scale(
    model: Any,
    input_ids: Tensor,
    attention_mask: Tensor,
    input_ids_idf: Optional[Tensor],
    num_layers: Optional[int],
    all_layers: bool,
    user_forward_fn: Optional[Callable],
) -> Tuple[Tensor, Tensor]:
    """Normalised, special-token-masked embeddings (B, layers, S, D) and the
    per-token idf scale (B, S), which sums to 1 over each sentence."""
    if user_forward_fn is not None:
        if all_layers:
            raise ValueError("The option `all_layers=True` can be used only with default `transformers` models.")
        out = user_forward_fn(model, {"input_ids": input_ids, "attention_mask": attention_mask})
        out = torch.as_tensor(out, device=input_ids.device)[:, None]  # add the layer axis
    else:
        outputs = model(input_ids=input_ids, attention_mask=attention_mask, output_hidden_states=True)
        hidden = outputs.hidden_states
        if all_layers:
            out = torch.stack(list(hidden), dim=1)
        else:
            out = hidden[num_layers if num_layers is not None else -1][:, None]

    # disabled idf degenerates to the processed mask, so ones keep one code path
    token_idf = input_ids_idf if input_ids_idf is not None else torch.ones(
        attention_mask.shape, dtype=out.dtype, device=out.device
    )
    return _finalize_embeddings(out, attention_mask, token_idf)


def _precision_recall_f1(
    preds_embeddings: Tensor, target_embeddings: Tensor, preds_idf_scale: Tensor, target_idf_scale: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Greedy-matching P/R/F1, shaped (L, B) and squeezed, through the
    ``maxsim`` kernel (``ops/kernels/cosine_matching.py``)."""
    return pairwise_cosine_pr(preds_embeddings, target_embeddings, preds_idf_scale, target_idf_scale)


def _read_csv_baseline(baseline_path: str, device: torch.device) -> Tensor:
    with open(baseline_path) as fname:
        rows = [[float(item) for item in row] for idx, row in enumerate(csv.reader(fname)) if idx > 0]
    return torch.tensor(rows, dtype=torch.float32, device=device)[:, 1:]


def _load_baseline(
    device: torch.device,
    lang: str = "en",
    model_name_or_path: Optional[str] = None,
    baseline_path: Optional[str] = None,
    baseline_url: Optional[str] = None,
) -> Optional[Tensor]:
    if baseline_path:
        return _read_csv_baseline(baseline_path, device)
    rank_zero_warn(
        "Baseline was not successfully loaded (remote baselines are unavailable without network access). "
        "No baseline is going to be used."
    )
    return None


def _rescale_metrics_with_baseline(
    precision: Tensor, recall: Tensor, f1: Tensor, baseline: Tensor, num_layers: Optional[int] = None,
    all_layers: bool = False,
) -> Tuple[Tensor, Tensor, Tensor]:
    if num_layers is None and all_layers is False:
        num_layers = -1
    all_metrics = torch.stack([precision, recall, f1], dim=-1)
    baseline_scale = baseline[:, None] if all_layers else baseline[num_layers]
    all_metrics = (all_metrics - baseline_scale) / (1 - baseline_scale)
    return all_metrics[..., 0], all_metrics[..., 1], all_metrics[..., 2]


def _as_numpy(x: Any) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, Tensor) else np.asarray(x)


def bert_score(
    preds: Union[List[str], Dict[str, Any]],
    target: Union[List[str], Dict[str, Any]],
    model_name_or_path: Optional[str] = None,
    num_layers: Optional[int] = None,
    all_layers: bool = False,
    model: Optional[Any] = None,
    user_tokenizer: Any = None,
    user_forward_fn: Optional[Callable] = None,
    verbose: bool = False,
    idf: bool = False,
    device: Optional[Union[str, torch.device]] = None,
    max_length: int = 512,
    batch_size: int = 64,
    num_threads: int = 0,
    return_hash: bool = False,
    lang: str = "en",
    rescale_with_baseline: bool = False,
    baseline_path: Optional[str] = None,
    baseline_url: Optional[str] = None,
) -> Dict[str, Union[List[float], str]]:
    """BERTScore precision/recall/f1 per sentence pair.

    Example (own encoder: a plain embedding table):
        >>> import numpy as np
        >>> import torch
        >>> from metrics_tpu_torch.ops import bert_score
        >>> VOCAB = ["[CLS]", "[SEP]", "[PAD]", "hello", "there", "master", "kenobi"]
        >>> table = torch.from_numpy(np.random.default_rng(0).normal(size=(len(VOCAB), 8)).astype(np.float32))
        >>> def tokenizer(sentences):
        ...     ids = np.full((len(sentences), 6), VOCAB.index("[PAD]"), dtype=np.int32)
        ...     mask = np.zeros((len(sentences), 6), dtype=np.int32)
        ...     for row, sent in enumerate(sentences):
        ...         for col, word in enumerate(["[CLS]"] + sent.split()[:4] + ["[SEP]"]):
        ...             ids[row, col] = VOCAB.index(word)
        ...             mask[row, col] = 1
        ...     return {"input_ids": ids, "attention_mask": mask}
        >>> out = bert_score(["hello there", "master kenobi"], ["hello there", "hello kenobi"],
        ...                  model=object(), user_tokenizer=tokenizer, max_length=6, device="cpu",
        ...                  user_forward_fn=lambda model, batch: table[batch["input_ids"]])
        >>> {key: [round(float(v), 4) for v in values] for key, values in out.items()}
        {'precision': [1.0, 0.5], 'recall': [1.0, 0.8545], 'f1': [1.0, 0.6309]}

    ``preds``/``target`` are lists of sentences, or pre-tokenized dicts with
    ``input_ids``/``attention_mask`` (arrays or tensors). ``device`` is where
    the encoder and the matching run: CUDA by default, raising when there is
    no card; pass ``"cpu"`` to run on the CPU. ``user_forward_fn(model,
    batch)`` receives int64 ``input_ids``/``attention_mask`` on that device and
    returns (B, S, D) float32 embeddings (a tensor or an array). Pass
    ``model`` (with ``user_tokenizer``/``user_forward_fn``) to supply your own
    encoder; without it a ``transformers`` checkpoint is loaded, which needs
    the package and the checkpoint on disk.
    """
    if isinstance(preds, (list, tuple)) and isinstance(target, (list, tuple)) and len(preds) != len(target):
        raise ValueError("`preds` and `target` must contain the same number of sentences.")
    device = resolve_device(device)

    if model is None:
        if not _TRANSFORMERS_AVAILABLE:
            raise ModuleNotFoundError(
                "`bert_score` metric with default models requires `transformers` package be installed."
            )
        if model_name_or_path is None:
            rank_zero_warn(
                "The argument `model_name_or_path` was not specified while it is required when the default"
                " `transformers` model is used."
                f" It will use the default recommended model - {_DEFAULT_MODEL!r}."
            )
        from transformers import AutoModel, AutoTokenizer

        model_name_or_path = model_name_or_path or _DEFAULT_MODEL
        tokenizer = AutoTokenizer.from_pretrained(model_name_or_path)
        model = AutoModel.from_pretrained(model_name_or_path).to(device).eval()
    else:
        tokenizer = user_tokenizer
    _are_empty_lists = all(isinstance(text, list) and len(text) == 0 for text in (preds, target))
    _are_valid_lists = all(
        isinstance(text, list) and len(text) > 0 and isinstance(text[0], str) for text in (preds, target)
    )
    _are_valid_tensors = all(
        isinstance(text, dict) and hasattr(text["input_ids"], "shape") for text in (preds, target)
    )
    if _are_empty_lists:
        rank_zero_warn("Predictions and references are empty.")
        output_dict: Dict[str, Union[List[float], str]] = {"precision": [0.0], "recall": [0.0], "f1": [0.0]}
        if return_hash:
            output_dict.update({"hash": _get_hash(model_name_or_path, num_layers, idf)})
        return output_dict
    if not (_are_valid_lists or _are_valid_tensors):
        raise ValueError("Invalid input provided.")

    if _are_valid_lists:
        target_tok = _preprocess_text(list(target), tokenizer, max_length)
        preds_tok = _preprocess_text(list(preds), tokenizer, max_length)
    else:
        target_tok = {k: _as_numpy(v) for k, v in target.items()}  # type: ignore[union-attr]
        preds_tok = {k: _as_numpy(v) for k, v in preds.items()}  # type: ignore[union-attr]

    tokens_idf = _get_tokens_idf(target_tok["input_ids"], target_tok["attention_mask"]) if idf else None

    def idf_array(tok: Dict[str, np.ndarray]) -> Optional[Tensor]:
        if tokens_idf is None:
            return None
        ids = np.vectorize(lambda i: tokens_idf[int(i)])(tok["input_ids"]).astype(np.float32)
        return torch.from_numpy(ids).to(device)

    def embed(tok: Dict[str, np.ndarray]) -> Tuple[Tensor, Tensor]:
        embs, scales = [], []
        n = tok["input_ids"].shape[0]
        idf_full = idf_array(tok)
        for start in range(0, n, batch_size):
            sl = slice(start, min(start + batch_size, n))
            e, s = _embed_and_scale(
                model,
                torch.as_tensor(tok["input_ids"][sl], dtype=torch.int64, device=device),
                torch.as_tensor(tok["attention_mask"][sl], dtype=torch.int64, device=device),
                idf_full[sl] if idf_full is not None else None,
                num_layers,
                all_layers,
                user_forward_fn,
            )
            embs.append(e)
            scales.append(s)
        return torch.cat(embs), torch.cat(scales)

    with torch.inference_mode():
        target_emb, target_idf_scale = embed(target_tok)
        preds_emb, preds_idf_scale = embed(preds_tok)
        precision, recall, f1 = _precision_recall_f1(preds_emb, target_emb, preds_idf_scale, target_idf_scale)

        if rescale_with_baseline:
            baseline = _load_baseline(device, lang, model_name_or_path, baseline_path, baseline_url)
            if baseline is not None:
                precision, recall, f1 = _rescale_metrics_with_baseline(
                    precision, recall, f1, baseline, num_layers, all_layers
                )

    # one host transfer per output
    output_dict = {
        "precision": _as_numpy(torch.atleast_1d(precision)).astype(np.float64).tolist(),
        "recall": _as_numpy(torch.atleast_1d(recall)).astype(np.float64).tolist(),
        "f1": _as_numpy(torch.atleast_1d(f1)).astype(np.float64).tolist(),
    }
    if return_hash:
        output_dict.update({"hash": _get_hash(model_name_or_path, num_layers, idf)})
    return output_dict


def _get_hash(model_name_or_path: Optional[str] = None, num_layers: Optional[int] = None, idf: bool = False) -> str:
    return f"{model_name_or_path}_L{num_layers}{'_idf' if idf else '_no-idf'}"
