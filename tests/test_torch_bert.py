"""The port's BERTScore against the JAX package's, on the CPU.

Both packages get the same sentences, the same tokenizer and the same
encoder: the toy embedding table of tests/text/test_bert.py (a numpy lookup
on the JAX side, a torch lookup on the port's), and, where ``transformers``
imports, one tiny 2-layer BERT saved in both formats with the same weights.

Tolerances, and why:

- Precision, recall and F1 with the embedding table: rtol=1e-5, atol=1e-6,
  the JAX package's own bound between its XLA and Pallas routes. Norms,
  similarity sums and idf sums run in different orders in XLA and PyTorch on
  the CPU, so results agree within rounding, not to the bit.
- Through the tiny BERT: rtol=1e-5, atol=1e-5; two encoders in two
  frameworks add their own rounding before the matching.
- Token states, packed arrays, processed masks and idf weights are bitwise:
  they are integer data or the same float64 logs rounded once to float32.
"""
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt_jax
import metrics_tpu_torch as mt_torch
from metrics_tpu.ops.text import bert as jax_bert_ops
from metrics_tpu.ops.text import bert_score as jax_bert_score
from metrics_tpu_torch.convert import state_from_numpy, state_to_numpy
from metrics_tpu_torch.ops import bert_score
from metrics_tpu_torch.ops.text import bert as bert_ops
from metrics_tpu_torch.text import bert as bert_module
from tests.helpers.torch_port import assert_bitwise, assert_close

VOCAB = ["[CLS]", "[SEP]", "[PAD]", "hello", "there", "general", "kenobi", "master", "world", "hi"]
DIM, MAX_LEN = 16, 8
TABLE = np.random.RandomState(0).randn(len(VOCAB), DIM).astype(np.float32)
TABLE_T = torch.from_numpy(TABLE)
RTOL, ATOL = 1e-5, 1e-6

PREDS = ["hello there", "master kenobi", "hello world", "general kenobi hello there", "hi"]
TARGET = ["hello there", "general kenobi", "hi world", "master kenobi there", "hi world hello"]


class ToyTokenizer:
    """Fixed width MAX_LEN; takes no transformers keywords (the TypeError route)."""

    def __call__(self, sentences):
        ids = np.full((len(sentences), MAX_LEN), VOCAB.index("[PAD]"), dtype=np.int32)
        mask = np.zeros((len(sentences), MAX_LEN), dtype=np.int32)
        for row, sent in enumerate(sentences):
            for col, tok in enumerate(["[CLS]"] + sent.split()[: MAX_LEN - 2] + ["[SEP]"]):
                ids[row, col] = VOCAB.index(tok)
                mask[row, col] = 1
        return {"input_ids": ids, "attention_mask": mask}


class VarWidthTokenizer:
    """Pads each batch to its own longest sentence."""

    def __call__(self, sentences):
        width = max(len(s.split()) for s in sentences) + 2
        ids = np.full((len(sentences), width), VOCAB.index("[PAD]"), dtype=np.int32)
        mask = np.zeros((len(sentences), width), dtype=np.int32)
        for row, sent in enumerate(sentences):
            for col, tok in enumerate(["[CLS]"] + sent.split()[: width - 2] + ["[SEP]"]):
                ids[row, col] = VOCAB.index(tok)
                mask[row, col] = 1
        return {"input_ids": ids, "attention_mask": mask}


def jax_forward(model, batch):
    return TABLE[np.asarray(batch["input_ids"])]


def torch_forward(model, batch):
    return TABLE_T[batch["input_ids"]]


def _jax_metric(tokenizer=None, **kwargs):
    return mt_jax.BERTScore(model=object(), user_tokenizer=tokenizer or ToyTokenizer(),
                            user_forward_fn=jax_forward, max_length=MAX_LEN, **kwargs)


def _port_metric(tokenizer=None, **kwargs):
    return mt_torch.BERTScore(model=object(), user_tokenizer=tokenizer or ToyTokenizer(),
                              user_forward_fn=torch_forward, max_length=MAX_LEN, device="cpu", **kwargs)


def _assert_scores_close(got, want, rtol=RTOL, atol=ATOL):
    assert set(got) == set(want)
    for key in ("precision", "recall", "f1"):
        assert_close(np.asarray(got[key]), np.asarray(want[key]), rtol=rtol, atol=atol, msg=key)
    if "hash" in want:
        assert got["hash"] == want["hash"]


def _functional(fn, forward, preds=PREDS, target=TARGET, **kwargs):
    extra = {"device": "cpu"} if fn is bert_score else {}
    return fn(preds, target, model=object(), user_tokenizer=ToyTokenizer(), user_forward_fn=forward,
              max_length=MAX_LEN, **extra, **kwargs)


@pytest.mark.parametrize("idf", [False, True])
def test_functional_matches_jax(idf):
    got = _functional(bert_score, torch_forward, idf=idf)
    _assert_scores_close(got, _functional(jax_bert_score, jax_forward, idf=idf))
    assert all(isinstance(v, float) for v in got["f1"]) and len(got["f1"]) == len(PREDS)


@pytest.mark.parametrize("batch_size", [1, 2, 64])
@pytest.mark.parametrize("idf", [False, True])
def test_module_matches_jax(idf, batch_size):
    jax_metric, port_metric = _jax_metric(idf=idf, batch_size=batch_size), _port_metric(idf=idf, batch_size=batch_size)
    jax_metric.update(PREDS, TARGET)
    port_metric.update(PREDS, TARGET)
    _assert_scores_close(port_metric.compute(), jax_metric.compute())


def test_multi_update_accumulation_and_token_states_bitwise():
    jax_metric, port_metric = _jax_metric(idf=True), _port_metric(idf=True)
    for lo, hi in ((0, 2), (2, 3), (3, 5)):
        jax_metric.update(PREDS[lo:hi], TARGET[lo:hi])
        port_metric.update(PREDS[lo:hi], TARGET[lo:hi])
    jax_state = jax_metric.get_state()
    port_state = state_to_numpy(port_metric)
    for name in mt_torch.BERTScore._STATE_NAMES:
        assert len(port_state[name]) == len(jax_state[name]) == 3
        for got, want in zip(port_state[name], jax_state[name]):
            assert_bitwise(got, np.asarray(want), msg=name)
        assert all(t.dtype == torch.int32 and t.device.type == "cpu" for t in getattr(port_metric, name))
    packed_jax, packed_port = jax_metric._packed_arrays(), port_metric._packed_arrays()
    for name in mt_torch.BERTScore._STATE_NAMES:
        assert_bitwise(packed_port[name], packed_jax[name], msg=name)
    _assert_scores_close(port_metric.compute(), jax_metric.compute())


def test_variable_width_tokenizer():
    preds = ["hello there", "general kenobi master hello world", "hi"]
    target = ["hello there", "master kenobi", "world"]
    jax_metric, port_metric = _jax_metric(VarWidthTokenizer()), _port_metric(VarWidthTokenizer())
    for sl in (slice(0, 1), slice(1, 2), slice(2, 3)):  # widths 4, 7, 3
        jax_metric.update(preds[sl], target[sl])
        port_metric.update(preds[sl], target[sl])
    got = port_metric.compute()
    _assert_scores_close(got, jax_metric.compute())
    # the ragged accumulation is width-invariant: the same pairs in one fixed-width update
    fixed = _port_metric()
    fixed.update(preds, target)
    assert_close(np.asarray(got["f1"]), np.asarray(fixed.compute()["f1"]), rtol=RTOL, atol=ATOL)


def test_packed_cache_is_cat_padded_and_amortised():
    sentences = ["hello there", "master kenobi hello", "hi world general kenobi master", "hello"]
    jax_metric, port_metric = _jax_metric(VarWidthTokenizer()), _port_metric(VarWidthTokenizer())
    n_updates = 64
    for i in range(n_updates):
        pair = ([sentences[i % 4]], [sentences[(i + 1) % 4]])
        jax_metric.update(*pair)
        port_metric.update(*pair)
    packed = port_metric._packed_arrays()
    assert packed is not None
    packed_jax = jax_metric._packed_arrays()
    for name in port_metric._STATE_NAMES:
        legacy = mt_torch.BERTScore._cat_padded(getattr(port_metric, name))
        assert_bitwise(packed[name], legacy, msg=name)
        assert_bitwise(packed[name], packed_jax[name], msg=name)
    rows = port_metric._packed["preds_input_ids"].rows
    assert rows == n_updates
    assert port_metric._packed_stats["rows_copied"] <= 2 * 4 * rows
    assert port_metric._packed_stats == jax_metric._packed_stats

    got = port_metric.compute()
    port_metric._packed = {}
    port_metric._computed = None
    fallback = port_metric.compute()
    for key in ("precision", "recall", "f1"):
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(fallback[key]), err_msg=key)
    _assert_scores_close(got, jax_metric.compute())


def test_reset_and_set_state_fall_back_to_cat_padded():
    metric = _port_metric()
    metric.update(PREDS[:2], TARGET[:2])
    metric.reset()
    assert metric._packed == {} and metric.preds_input_ids == []
    metric.update(["hello"], ["hello"])
    assert metric._packed_arrays() is not None
    metric.set_state(metric.get_state())
    assert metric._packed_arrays() is None
    np.testing.assert_allclose(np.asarray(metric.compute()["f1"]), [1.0], atol=1e-5)


def test_empty_sentence_gives_nan_precision_and_zero_f1():
    preds, target = ["", "hello there"], ["hello", "hello there"]
    got = _functional(bert_score, torch_forward, preds, target)
    want = _functional(jax_bert_score, jax_forward, preds, target)
    _assert_scores_close(got, want)
    assert math.isnan(got["precision"][0]) and got["f1"][0] == 0.0


def test_empty_lists_mismatched_lengths_and_hash():
    for fn, fwd in ((bert_score, torch_forward), (jax_bert_score, jax_forward)):
        with pytest.warns(UserWarning, match="empty"):
            out = _functional(fn, fwd, [], [], return_hash=True)
        assert out == {"precision": [0.0], "recall": [0.0], "f1": [0.0], "hash": "None_LNone_no-idf"}
        with pytest.raises(ValueError, match="same number"):
            _functional(fn, fwd, ["a", "b"], ["a"])
        with pytest.raises(ValueError, match="Invalid input"):
            _functional(fn, fwd, [1, 2], [3, 4])
    got = _functional(bert_score, torch_forward, return_hash=True, idf=True)
    _assert_scores_close(got, _functional(jax_bert_score, jax_forward, return_hash=True, idf=True))
    assert got["hash"] == "None_LNone_idf"


def test_pretokenized_dicts_of_arrays_or_tensors():
    tok = ToyTokenizer()
    p, t = tok(PREDS), tok(TARGET)
    want = jax_bert_score(p, t, model=object(), user_forward_fn=jax_forward)
    for conv in (np.asarray, torch.from_numpy):
        got = bert_score({k: conv(v) for k, v in p.items()}, {k: conv(v) for k, v in t.items()},
                         model=object(), user_forward_fn=torch_forward, device="cpu")
        _assert_scores_close(got, want)


def test_baseline_rescale(tmp_path):
    path = tmp_path / "baseline.csv"
    path.write_text("LAYER,P,R,F\n0,0.1,0.2,0.3\n1,0.5,0.4,0.2\n")
    kwargs = dict(rescale_with_baseline=True, baseline_path=str(path))
    got = _functional(bert_score, torch_forward, **kwargs)
    _assert_scores_close(got, _functional(jax_bert_score, jax_forward, **kwargs))
    plain = _functional(bert_score, torch_forward)
    np.testing.assert_allclose(got["f1"], (np.asarray(plain["f1"]) - 0.2) / 0.8, rtol=1e-5, atol=1e-6)
    with pytest.warns(UserWarning, match="Baseline was not successfully loaded"):
        unscaled = _functional(bert_score, torch_forward, rescale_with_baseline=True)
    assert unscaled == plain


def test_forward_returns_the_batch_and_accumulates():
    jax_metric, port_metric = _jax_metric(), _port_metric()
    for sl in (slice(0, 2), slice(2, 5)):
        _assert_scores_close(port_metric(PREDS[sl], TARGET[sl]), jax_metric(PREDS[sl], TARGET[sl]))
    assert len(port_metric.preds_input_ids) == 2 and port_metric._packed_arrays() is None
    _assert_scores_close(port_metric.compute(), jax_metric.compute())


def test_state_carries_from_jax_into_the_port():
    """A stream starts in metrics_tpu.BERTScore and continues in the port."""
    jax_metric = _jax_metric(idf=True)
    jax_metric.update(PREDS[:3], TARGET[:3])
    arrays = {k: [np.asarray(x) for x in v] for k, v in jax_metric.get_state().items()}
    carried = _port_metric(idf=True)
    state = state_from_numpy(carried, arrays)
    assert all(t.dtype == torch.int32 for t in state["preds_input_ids"])
    carried.update(PREDS[3:], TARGET[3:])
    alone = _port_metric(idf=True)
    alone.update(PREDS[:3], TARGET[:3])
    alone.update(PREDS[3:], TARGET[3:])
    got = carried.compute()
    want = alone.compute()
    for key in ("precision", "recall", "f1"):
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
    jax_metric.update(PREDS[3:], TARGET[3:])
    _assert_scores_close(got, jax_metric.compute())
    back = state_to_numpy(carried)
    assert [a.shape for a in back["target_input_ids"]] == [(3, MAX_LEN), (2, MAX_LEN)]


def test_list_state_conversion_checks_dtypes():
    metric = _port_metric()
    good = {name: [np.zeros((2, MAX_LEN), np.int32)] for name in metric._STATE_NAMES}
    state_from_numpy(metric, good)
    with pytest.raises(ValueError, match="int32 or float32"):
        state_from_numpy(metric, {**good, "preds_input_ids": [np.zeros((2, MAX_LEN), np.int64)]})
    with pytest.raises(ValueError, match="list of arrays"):
        state_from_numpy(metric, {**good, "target_attention_mask": np.zeros((2, MAX_LEN), np.int32)})


def test_masks_and_idf_are_bitwise():
    tok = ToyTokenizer()(TARGET + ["", "hi hi hi"])
    ids, mask = tok["input_ids"], tok["attention_mask"]
    want_idf = jax_bert_ops._get_tokens_idf(ids, mask)
    got_idf = bert_ops._get_tokens_idf(ids, mask)
    assert dict(got_idf) == dict(want_idf) and got_idf[12345] == want_idf[12345]
    assert_bitwise(
        bert_ops._process_attention_mask_for_special_tokens(torch.from_numpy(mask)),
        np.asarray(jax_bert_ops._process_attention_mask_for_special_tokens(jnp.asarray(mask))),
    )
    emb = TABLE[ids][:, None]
    token_idf = np.vectorize(lambda i: want_idf[int(i)])(ids).astype(np.float32)
    got = bert_ops._finalize_embeddings(torch.from_numpy(emb), torch.from_numpy(mask), torch.from_numpy(token_idf))
    want = jax_bert_ops._finalize_embeddings(jnp.asarray(emb), jnp.asarray(mask), jnp.asarray(token_idf))
    for g, w, name in zip(got, want, ("embeddings", "idf scale")):
        assert_close(g, np.asarray(w), rtol=RTOL, atol=ATOL, msg=name)


def test_user_forward_fn_refuses_all_layers():
    for fn, fwd in ((bert_score, torch_forward), (jax_bert_score, jax_forward)):
        with pytest.raises(ValueError, match="all_layers"):
            _functional(fn, fwd, all_layers=True)


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt_torch.BERTScore(model=object(), user_tokenizer=ToyTokenizer(), user_forward_fn=torch_forward)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bert_score(PREDS, TARGET, model=object(), user_tokenizer=ToyTokenizer(), user_forward_fn=torch_forward)


def test_default_route_needs_transformers(monkeypatch):
    monkeypatch.setattr(bert_ops, "_TRANSFORMERS_AVAILABLE", False)
    monkeypatch.setattr(bert_module, "_TRANSFORMERS_AVAILABLE", False)
    with pytest.raises(ModuleNotFoundError, match="transformers"):
        bert_score(PREDS, TARGET, device="cpu")
    with pytest.raises(ModuleNotFoundError, match="transformers"):
        mt_torch.BERTScore(device="cpu")


# --------------------------------------------------------------------------- #
# the default transformers route, over one tiny BERT saved in both formats
# --------------------------------------------------------------------------- #
BERT_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "hello", "there", "master", "kenobi", "general"]
BERT_PREDS = ["hello there", "master kenobi", "general kenobi there"]
BERT_TARGET = ["hello there", "hello kenobi general", "master there"]


@pytest.fixture(scope="module")
def tiny_bert_dir(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
    path = tmp_path_factory.mktemp("tiny_bert_both")
    (path / "vocab.txt").write_text("\n".join(BERT_VOCAB))
    transformers.BertTokenizer(str(path / "vocab.txt")).save_pretrained(str(path))
    config = transformers.BertConfig(
        vocab_size=len(BERT_VOCAB), hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=32, max_position_embeddings=32,
    )
    torch.manual_seed(0)
    transformers.BertModel(config).save_pretrained(str(path))
    try:
        transformers.FlaxBertModel.from_pretrained(str(path), from_pt=True).save_pretrained(str(path))
    except Exception as err:  # pragma: no cover - depends on the installed transformers
        pytest.skip(f"cannot write the same weights in Flax format here: {err}")
    return str(path)


@pytest.mark.parametrize(
    "options",
    [{}, {"idf": True}, {"num_layers": 1}, {"all_layers": True}],
    ids=["last-layer", "idf", "num_layers=1", "all_layers"],
)
def test_default_route_matches_jax(tiny_bert_dir, options):
    jax_metric = mt_jax.BERTScore(model_name_or_path=tiny_bert_dir, max_length=16, **options)
    port_metric = mt_torch.BERTScore(model_name_or_path=tiny_bert_dir, max_length=16, device="cpu", **options)
    assert not port_metric.model.training
    jax_metric.update(BERT_PREDS, BERT_TARGET)
    port_metric.update(BERT_PREDS, BERT_TARGET)
    got, want = port_metric.compute(), jax_metric.compute()
    _assert_scores_close(got, want, rtol=1e-5, atol=1e-5)
    if options.get("all_layers"):
        assert np.asarray(got["f1"]).shape == (3, len(BERT_PREDS))  # embeddings and 2 layers
    else:
        assert got["f1"][0] == pytest.approx(1.0, abs=1e-4)  # the identical pair
    functional = bert_score(BERT_PREDS, BERT_TARGET, model_name_or_path=tiny_bert_dir, max_length=16,
                            device="cpu", **options)
    _assert_scores_close(functional, got, rtol=1e-6, atol=1e-7)
