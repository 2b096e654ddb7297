"""BERTScore module.

Counterpart of ``metrics_tpu/text/bert.py``. ``update`` tokenizes on the host
and appends the token batches to four ``cat`` list states (int32 tensors on
the metric's device); ``compute`` runs the encoder and the greedy matching
through :func:`metrics_tpu_torch.ops.text.bert.bert_score`.

Token batches are also packed on append into pow2-width host buffers
(:class:`_PackedCat`), so ``compute`` does not re-pad the whole history: a
re-pad of every batch on every compute costs O(N²) copies over N updates,
while the packed buffers amortise to O(1) copies per appended row (geometric
row growth and at most log2(max width) width re-buckets). Their trimmed view
is byte-identical to :meth:`BERTScore._cat_padded`, which stays as the
fallback after an out-of-band state replacement.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.text.bert import _DEFAULT_MODEL, _preprocess_text, bert_score
from metrics_tpu_torch.utils.imports import _TRANSFORMERS_AVAILABLE
from metrics_tpu_torch.utils.prints import rank_zero_warn

# host dtypes of a token batch and the state dtype each is kept in (int32 and
# float32 state, as in the JAX package)
_STATE_DTYPES = {np.dtype(np.int64): np.int32, np.dtype(np.float64): np.float32}


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


class _PackedCat:
    """Pad-on-append accumulator for ragged-width token batches.

    Rows land in a single host buffer whose width is the pow2 bucket of the
    widest batch seen so far and whose row capacity grows geometrically, so
    total copy work is O(rows appended) regardless of update count. ``stats``
    (shared across a metric's four buffers) counts reallocations.
    """

    __slots__ = ("data", "rows", "true_width", "n_batches", "stats")

    def __init__(self, stats: Dict[str, int]) -> None:
        self.data: Optional[np.ndarray] = None
        self.rows = 0
        self.true_width = 0  # widest batch so far (buffer width is its pow2 bucket)
        self.n_batches = 0  # consumed batches; compute() checks == len(list state)
        self.stats = stats

    def append(self, batch: Any) -> bool:
        a = np.asarray(batch)
        if a.ndim < 2:
            return False
        if self.data is not None and (a.dtype != self.data.dtype or a.shape[2:] != self.data.shape[2:]):
            return False  # heterogeneous batches: leave to the _cat_padded fallback
        self.true_width = max(self.true_width, a.shape[1])
        width = _next_pow2(self.true_width)
        need_rows = self.rows + a.shape[0]
        if self.data is None:
            self.data = np.zeros((_next_pow2(need_rows), width) + a.shape[2:], dtype=a.dtype)
        elif width > self.data.shape[1] or need_rows > self.data.shape[0]:
            grown = np.zeros(
                (max(_next_pow2(need_rows), self.data.shape[0]), max(width, self.data.shape[1]))
                + self.data.shape[2:],
                dtype=self.data.dtype,
            )
            grown[: self.rows, : self.data.shape[1]] = self.data[: self.rows]
            self.stats["repads"] += 1
            self.stats["rows_copied"] += self.rows
            self.data = grown
        self.data[self.rows : need_rows, : a.shape[1]] = a
        self.rows = need_rows
        self.n_batches += 1
        return True

    def to_array(self) -> np.ndarray:
        assert self.data is not None
        return self.data[: self.rows, : self.true_width]


class BERTScore(Metric):
    """BERTScore.

    Pass ``model``/``user_tokenizer``/``user_forward_fn`` to use your own
    PyTorch encoder; without ``model`` a ``transformers`` checkpoint is
    loaded (``model_name_or_path``, default ``roberta-large``), which needs
    the package and the checkpoint on disk. The encoder and the matching run
    on the metric's device. ``to(device)`` moves a model the metric loaded
    itself; a model passed in is the caller's to move.

    Synced over several processes, the token states of every rank must have
    one width: a tokenizer that pads each batch to its longest sentence
    gives ranks different widths, and the sync raises (as the JAX package
    cannot concatenate them either). The default tokenizer pads to
    ``max_length``.

    Example (own encoder: here a plain embedding table):
        >>> import numpy as np
        >>> import torch
        >>> from metrics_tpu_torch import BERTScore
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
        >>> score = BERTScore(
        ...     model=object(),
        ...     user_tokenizer=tokenizer,
        ...     user_forward_fn=lambda model, batch: table[batch["input_ids"]],
        ...     max_length=6,
        ...     device="cpu",
        ... )
        >>> score.update(["hello there", "master kenobi"], ["hello there", "hello kenobi"])
        >>> {key: [round(float(v), 4) for v in values] for key, values in score.compute().items()}
        {'precision': [1.0, 0.5], 'recall': [1.0, 0.8545], 'f1': [1.0, 0.6309]}
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    _STATE_NAMES: Tuple[str, ...] = (
        "preds_input_ids",
        "preds_attention_mask",
        "target_input_ids",
        "target_attention_mask",
    )

    def __init__(
        self,
        model_name_or_path: Optional[str] = None,
        num_layers: Optional[int] = None,
        all_layers: bool = False,
        model: Optional[Any] = None,
        user_tokenizer: Optional[Any] = None,
        user_forward_fn: Optional[Callable] = None,
        verbose: bool = False,
        idf: bool = False,
        max_length: int = 512,
        batch_size: int = 64,
        num_threads: int = 0,
        return_hash: bool = False,
        lang: str = "en",
        rescale_with_baseline: bool = False,
        baseline_path: Optional[str] = None,
        baseline_url: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.model_name_or_path = model_name_or_path
        self.num_layers = num_layers
        self.all_layers = all_layers
        self.model = model
        self.user_forward_fn = user_forward_fn
        self.verbose = verbose
        self.idf = idf
        self.max_length = max_length
        self.batch_size = batch_size
        self.num_threads = num_threads
        self.return_hash = return_hash
        self.lang = lang
        self.rescale_with_baseline = rescale_with_baseline
        self.baseline_path = baseline_path
        self.baseline_url = baseline_url

        if model is None:
            if not _TRANSFORMERS_AVAILABLE:
                raise ModuleNotFoundError(
                    "`BERTScore` metric with default models requires `transformers` package be installed."
                )
            if model_name_or_path is None:
                rank_zero_warn(
                    "The argument `model_name_or_path` was not specified while it is required when default"
                    " `transformers` model are used."
                    f" It will use the default recommended model - {_DEFAULT_MODEL!r}."
                )
            from transformers import AutoModel, AutoTokenizer

            self.model_name_or_path = model_name_or_path or _DEFAULT_MODEL
            self.tokenizer = AutoTokenizer.from_pretrained(self.model_name_or_path)
            # load once here so repeated compute() calls don't re-read the weights
            self.model = AutoModel.from_pretrained(self.model_name_or_path).to(self.device).eval()
        else:
            self.tokenizer = user_tokenizer
        self._owns_model = model is None

        for name in self._STATE_NAMES:
            self.add_state(name, default=[], dist_reduce_fx="cat")
        self._packed_stats: Dict[str, int] = {"repads": 0, "rows_copied": 0}
        self._packed: Dict[str, _PackedCat] = {}

    def update(self, preds: List[str], target: List[str]) -> None:  # type: ignore[override]
        preds_dict = _preprocess_text(list(preds), self.tokenizer, self.max_length)
        target_dict = _preprocess_text(list(target), self.tokenizer, self.max_length)
        batches = {
            "preds_input_ids": preds_dict["input_ids"],
            "preds_attention_mask": preds_dict["attention_mask"],
            "target_input_ids": target_dict["input_ids"],
            "target_attention_mask": target_dict["attention_mask"],
        }
        for name, batch in batches.items():
            host = np.asarray(batch)
            state = torch.from_numpy(np.array(host, dtype=_STATE_DTYPES.get(host.dtype, host.dtype)))  # a copy
            setattr(self, name, getattr(self, name) + [state.to(self.device)])
            packed = self._packed.get(name)
            if packed is None:
                packed = self._packed[name] = _PackedCat(self._packed_stats)
            if not packed.append(batch):
                self._packed.pop(name, None)  # unpackable batch: compute falls back

    def reset(self) -> None:
        super().reset()
        self._packed = {}

    def _move_attributes(self, device: torch.device) -> None:
        if self._owns_model:
            self.model = self.model.to(device)

    def set_state(self, state: Dict[str, Any]) -> None:
        # an out-of-band state replacement (a restore, a merge, a sync or an
        # unsync, a state carried from the JAX package) bypasses update():
        # drop the packed mirrors so compute re-pads from the list states
        super().set_state(state)
        self._packed = {}

    def _packed_arrays(self) -> Optional[Dict[str, np.ndarray]]:
        """The packed mirrors, iff they cover the list states exactly."""
        out: Dict[str, np.ndarray] = {}
        for name in self._STATE_NAMES:
            packed = self._packed.get(name)
            if packed is None or packed.n_batches != len(getattr(self, name)):
                return None
            out[name] = packed.to_array()
        return out

    @staticmethod
    def _cat_padded(batches: List[Tensor]) -> np.ndarray:
        """Concatenate token batches whose padded widths may differ between
        ``update`` calls (a user tokenizer may pad each batch to its own
        longest sentence); right-pad everything to the widest batch."""
        arrs = [x.detach().cpu().numpy() for x in batches]
        width = max(a.shape[1] for a in arrs)

        def pad(a: np.ndarray) -> np.ndarray:
            # the token axis only; ids may be (B, S) or embedding-valued (B, S, D)
            widths = [(0, 0)] * a.ndim
            widths[1] = (0, width - a.shape[1])
            return np.pad(a, widths)

        return np.concatenate([pad(a) for a in arrs])

    def compute(self) -> Dict[str, Union[List[float], str]]:
        packed = self._packed_arrays()
        if packed is not None:
            preds = {"input_ids": packed["preds_input_ids"], "attention_mask": packed["preds_attention_mask"]}
            target = {"input_ids": packed["target_input_ids"], "attention_mask": packed["target_attention_mask"]}
        else:
            preds = {
                "input_ids": self._cat_padded(self.preds_input_ids),
                "attention_mask": self._cat_padded(self.preds_attention_mask),
            }
            target = {
                "input_ids": self._cat_padded(self.target_input_ids),
                "attention_mask": self._cat_padded(self.target_attention_mask),
            }
        return bert_score(
            preds=preds,
            target=target,
            model_name_or_path=self.model_name_or_path,
            num_layers=self.num_layers,
            all_layers=self.all_layers,
            model=self.model,
            user_tokenizer=self.tokenizer if self.model is not None else None,
            user_forward_fn=self.user_forward_fn,
            verbose=self.verbose,
            idf=self.idf,
            device=self.device,
            max_length=self.max_length,
            batch_size=self.batch_size,
            return_hash=self.return_hash,
            lang=self.lang,
            rescale_with_baseline=self.rescale_with_baseline,
            baseline_path=self.baseline_path,
            baseline_url=self.baseline_url,
        )
