"""The text metrics of the port other than BERTScore (A13) against the JAX
package's, and against the oracles the JAX package's tests use (sacrebleu,
nltk, rouge_score, sklearn-free DPs).

Torch twins of ``tests/text/test_error_rates.py``, ``test_bleu_chrf_ter.py``
and ``test_rouge_squad_eed.py``: the same inputs through both packages on the
CPU. States that are float32 sums of integers (edit distances and lengths,
BLEU and chrF counts, SQuAD's count) and the sentence-score lists compare bit
for bit; results within 1e-6. The batched edit-distance scan is held bit for
bit against the pure-Python DP and the JAX scan on seeded ragged batches with
empty sentences and widths that are not multiples of 16.
"""
import pathlib
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import metrics_tpu as M
import metrics_tpu.ops.text as jax_text
import metrics_tpu_torch as mt
from metrics_tpu.ops.text import helper as jax_helper
from metrics_tpu_torch.ops import text as port_text
from metrics_tpu_torch.ops.text import helper
from tests.helpers.torch_port import assert_bitwise, local_punkt_only

pytestmark = pytest.mark.filterwarnings("ignore")
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _no_punkt_download(monkeypatch):
    local_punkt_only(monkeypatch)


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64), **{**TOL, **kw})


def _same_states(port, ref, msg=""):
    """Every registered state bit for bit (a list state entry by entry)."""
    assert set(port._defaults) == set(ref._defaults), msg
    for key in ref._defaults:
        got, want = getattr(port, key), getattr(ref, key)
        if isinstance(want, list):
            assert len(got) == len(want), f"{msg}: {key}"
            for g, w in zip(got, want):
                assert_bitwise(g, np.asarray(w), f"{msg}: {key}")
        else:
            assert_bitwise(got, np.asarray(want), f"{msg}: {key}")


def _leaves(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for item in x for v in _leaves(item)]
    return [np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, dtype=np.float64)]


def _same_results(got, want):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        _close(a, b)


def _pair(name, **kw):
    return getattr(M, name)(**kw), getattr(mt, name)(device="cpu", **kw)


def _feed_pair(name, calls, **kw):
    ref, port = _pair(name, **kw)
    for args in calls:
        ref.update(*args)
        port.update(*args)
    _same_states(port, ref, name)
    _same_results(port.compute(), ref.compute())
    return ref, port


# --------------------------------------------------------------------------- #
# the batched edit-distance scan
# --------------------------------------------------------------------------- #
def _oracle_edit(a, b):
    dp = [[0] * (len(b) + 1) for _ in range(len(a) + 1)]
    for i in range(len(a) + 1):
        dp[i][0] = i
    for j in range(len(b) + 1):
        dp[0][j] = j
    for i in range(1, len(a) + 1):
        for j in range(1, len(b) + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            dp[i][j] = min(dp[i - 1][j] + 1, dp[i][j - 1] + 1, dp[i - 1][j - 1] + cost)
    return dp[-1][-1]


def _ragged(seed, n, max_p, max_r, vocab=5):
    rng = np.random.default_rng(seed)
    words = [str(w) for w in range(vocab)]
    preds = [[words[i] for i in rng.integers(0, vocab, rng.integers(0, max_p + 1))] for _ in range(n)]
    refs = [[words[i] for i in rng.integers(0, vocab, rng.integers(0, max_r + 1))] for _ in range(n)]
    return preds, refs


@pytest.mark.parametrize("seed,n,max_p,max_r", [(0, 20, 12, 15), (1, 33, 17, 40), (2, 7, 47, 3), (3, 64, 31, 33),
                                                (4, 1, 0, 0), (5, 5, 100, 1)])
def test_scan_is_bitwise_against_the_dp_and_the_jax_scan(seed, n, max_p, max_r):
    preds, refs = _ragged(seed, n, max_p, max_r)
    got = helper.batch_edit_distances(preds, refs, torch.device("cpu"))
    assert got.dtype == torch.int32 and got.shape == (n,)
    want = [_oracle_edit(p, r) for p, r in zip(preds, refs)]
    assert got.tolist() == want == [helper._edit_distance_host(p, r) for p, r in zip(preds, refs)]
    assert_bitwise(got, np.asarray(jax_helper.batch_edit_distances(preds, refs)), "JAX scan")


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(st.lists(st.sampled_from("abcd"), max_size=21), st.lists(st.sampled_from("abcd"),
                                                                                     max_size=19)),
                min_size=1, max_size=9))
def test_scan_hypothesis(pairs):
    preds, refs = [p for p, _ in pairs], [r for _, r in pairs]
    got = helper.batch_edit_distances(preds, refs, torch.device("cpu")).tolist()
    assert got == [helper._edit_distance_host(p, r) for p, r in zip(preds, refs)]


def test_scan_on_unpadded_widths_and_explicit_lengths():
    """``edit_distance_batch`` on widths that are not multiples of 16, with
    padding beyond the lengths that must not count."""
    pred = torch.tensor([[1, 2, 3, 9, 9], [4, 4, 0, 0, 0], [7, 7, 7, 7, 7]], dtype=torch.int32)
    ref = torch.tensor([[1, 3, -2], [4, -2, -2], [-2, -2, -2]], dtype=torch.int32)
    got = helper.edit_distance_batch(pred, torch.tensor([3, 2, 0]), ref, torch.tensor([2, 1, 0]))
    assert got.tolist() == [1, 1, 0]
    want = jax_helper.edit_distance_batch(*map(jnp.asarray, (pred.numpy(), np.asarray([3, 2, 0]), ref.numpy(),
                                                             np.asarray([2, 1, 0]))))
    assert_bitwise(got, np.asarray(want), "JAX scan")


def test_scan_empty_and_edge_cases():
    assert helper.batch_edit_distances([[], ["a", "b"]], [["x"], []]).tolist() == [1, 2]
    assert helper.batch_edit_distances([], []).shape == (0,)
    assert helper._edit_distance_host(list("kitten"), list("sitting")) == 3


def test_encode_token_batch_matches_jax():
    preds, refs = [["a", "b", "c"], [], ["c", "d"]], [["b"], ["a", "x", "y", "z"], []]
    got = helper.encode_token_batch(preds, refs)
    want = jax_helper.encode_token_batch(preds, refs)
    for g, w, name in zip(got, want, ("pred_ids", "pred_lens", "ref_ids", "ref_lens")):
        assert_bitwise(g, np.asarray(w), name)
    assert got[0].shape == (3, 16) and int(got[0][1, 0]) == -1 and int(got[2][2, 0]) == -2


def test_scan_stays_on_the_inputs_device_with_two_scan_ops_a_token():
    from torch.utils._python_dispatch import TorchDispatchMode

    calls = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            calls.append(func)
            return func(*args, **(kwargs or {}))

    enc = helper.encode_token_batch([["a", "b"]] * 3, [["b", "c", "d"]] * 3)
    with Count():
        out = helper.edit_distance_batch(*enc)
    assert out.device.type == "cpu" and out.tolist() == [3, 3, 3]
    work = [f for f in calls if f._overloadpacket in (torch.ops.aten.minimum, torch.ops.aten.cummin)]
    assert len(work) == 2 * enc[0].shape[1]  # one minimum and one cummin a prediction token


# --------------------------------------------------------------------------- #
# error rates
# --------------------------------------------------------------------------- #
PREDS = ["this is the prediction", "there is an other sample"]
TARGET = ["this is the reference", "there is another one"]
BATCHES = [
    (["hello world", "the quick brown fox"], ["hello duck", "the quick brown fox jumps"]),
    (["a b c d", "x"], ["a b d", "y z"]),
]
RATES = {
    "WordErrorRate": "word_error_rate", "CharErrorRate": "char_error_rate", "MatchErrorRate": "match_error_rate",
    "WordInfoLost": "word_information_lost", "WordInfoPreserved": "word_information_preserved",
}


def _oracle_wer(preds, target):
    errs = sum(_oracle_edit(p.split(), t.split()) for p, t in zip(preds, target))
    return errs / sum(len(t.split()) for t in target)


@pytest.mark.parametrize("preds,target", BATCHES + [(PREDS, TARGET)])
def test_wer_functional(preds, target):
    got = port_text.word_error_rate(preds, target, device="cpu")
    _close(got, _oracle_wer(preds, target))
    assert_bitwise(got, np.asarray(jax_text.word_error_rate(preds, target)), "JAX")


@pytest.mark.parametrize("fn,golden", [("word_error_rate", 0.5), ("match_error_rate", 0.4444),
                                       ("word_information_lost", 0.6528), ("word_information_preserved", 0.3472),
                                       ("char_error_rate", 0.3415)])
def test_docstring_goldens(fn, golden):
    got = getattr(port_text, fn)(PREDS, TARGET, device="cpu")
    _close(got, golden, atol=1e-4)
    _close(got, getattr(jax_text, fn)(PREDS, TARGET))


@pytest.mark.parametrize("name", sorted(RATES))
def test_modular_accumulation(name):
    ref, port = _feed_pair(name, BATCHES)
    preds = [p for b in BATCHES for p in b[0]]
    target = [t for b in BATCHES for t in b[1]]
    _close(port.compute(), getattr(port_text, RATES[name])(preds, target, device="cpu"))
    assert all(v.dtype == torch.float32 for v in port.get_state().values())


@pytest.mark.parametrize("name", sorted(RATES))
def test_error_rate_states_on_a_large_corpus_are_bitwise(name):
    rng = random.Random(7)
    vocab = [f"w{i}" for i in range(40)]
    calls = []
    for _ in range(3):
        preds = [" ".join(rng.choice(vocab) for _ in range(rng.randint(0, 25))) for _ in range(23)]
        target = [" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 30))) for _ in range(23)]
        calls.append((preds, target))
    _feed_pair(name, calls)


def test_merge_states_equals_single_corpus():
    metric = mt.WordErrorRate(device="cpu")
    s1 = metric.update_state(metric.init_state(), *BATCHES[0])
    s2 = metric.update_state(metric.init_state(), *BATCHES[1])
    got = metric.compute_state(metric.merge_states(s1, s2))
    want = port_text.word_error_rate(BATCHES[0][0] + BATCHES[1][0], BATCHES[0][1] + BATCHES[1][1], device="cpu")
    _close(got, want)


def test_single_string_inputs():
    assert float(port_text.word_error_rate("hello world", "hello world", device="cpu")) == 0.0
    assert float(port_text.char_error_rate("abc", "abc", device="cpu")) == 0.0
    with pytest.raises(ValueError, match="different size"):
        port_text.word_error_rate(["a"], ["a", "b"], device="cpu")


# --------------------------------------------------------------------------- #
# BLEU, SacreBLEU, chrF, TER
# --------------------------------------------------------------------------- #
MT_PREDS = [
    "the cat is on the mat",
    "there is a big tree near the house",
    "hello there general kenobi",
    "it is a guide to action which ensures that the military always obeys the commands of the party",
    "the dog, which was lazy, slept all day; the cat did not.",
]
MT_TARGETS = [
    ["there is a cat on the mat", "a cat is on the mat"],
    ["a big tree is near the house", "there is a tall tree by the house"],
    ["hello there general kenobi", "hi there master kenobi"],
    [
        "it is a guide to action that ensures that the military will forever heed party commands",
        "it is the guiding principle which guarantees the military forces always being under the command of the party",
    ],
    ["the lazy dog slept all day, but the cat did not.", "the dog, being lazy, slept; the cat didn't."],
]
MT_CALLS = [(MT_PREDS[:2], MT_TARGETS[:2]), (MT_PREDS[2:], MT_TARGETS[2:])]


def _transposed_refs():
    max_refs = max(len(r) for r in MT_TARGETS)
    return [[refs[i] if i < len(refs) else refs[0] for refs in MT_TARGETS] for i in range(max_refs)]


@pytest.mark.parametrize("n_gram", [2, 4])
def test_bleu_vs_nltk(n_gram):
    from nltk.translate.bleu_score import corpus_bleu

    weights = tuple(1.0 / n_gram for _ in range(n_gram))
    want = corpus_bleu([[t.split() for t in refs] for refs in MT_TARGETS], [p.split() for p in MT_PREDS],
                       weights=weights)
    got = port_text.bleu_score(MT_PREDS, MT_TARGETS, n_gram=n_gram, device="cpu")
    _close(got, want)
    _close(got, jax_text.bleu_score(MT_PREDS, MT_TARGETS, n_gram=n_gram))


def test_bleu_smooth_vs_nltk():
    from nltk.translate.bleu_score import SmoothingFunction, corpus_bleu

    want = corpus_bleu([[t.split() for t in refs] for refs in MT_TARGETS], [p.split() for p in MT_PREDS],
                       smoothing_function=SmoothingFunction().method2)
    _close(port_text.bleu_score(MT_PREDS, MT_TARGETS, smooth=True, device="cpu"), want)


def test_bleu_golden_and_empty_ngram():
    got = port_text.bleu_score(["the cat is on the mat"], [["there is a cat on the mat", "a cat is on the mat"]],
                               device="cpu")
    _close(got, 0.7598, atol=1e-4)
    assert float(port_text.bleu_score(["xyz"], [["abc"]], device="cpu")) == 0.0


@pytest.mark.parametrize("name,kw", [("BLEUScore", {}), ("BLEUScore", {"n_gram": 2, "smooth": True}),
                                     ("SacreBLEUScore", {}), ("SacreBLEUScore", {"tokenize": "intl", "lowercase": True}),
                                     ("CHRFScore", {}), ("CHRFScore", {"n_word_order": 0, "beta": 1.0}),
                                     ("CHRFScore", {"return_sentence_level_score": True, "lowercase": True}),
                                     ("TranslationEditRate", {}),
                                     ("TranslationEditRate", {"return_sentence_level_score": True, "normalize": True})])
def test_module_accumulation_matches_jax(name, kw):
    _feed_pair(name, MT_CALLS, **kw)


@pytest.mark.parametrize("tokenize", ["none", "13a", "char", "intl", "zh"])
@pytest.mark.parametrize("lowercase", [False, True])
def test_sacrebleu_vs_sacrebleu(tokenize, lowercase):
    from sacrebleu.metrics import BLEU

    want = BLEU(tokenize=tokenize, lowercase=lowercase).corpus_score(MT_PREDS, _transposed_refs()).score / 100.0
    padded = [refs + [refs[0]] * (len(_transposed_refs()) - len(refs)) for refs in MT_TARGETS]
    got = port_text.sacre_bleu_score(MT_PREDS, padded, tokenize=tokenize, lowercase=lowercase, device="cpu")
    _close(got, want, atol=1e-5)


def test_sacrebleu_zh_chinese_corpus():
    from sacrebleu.metrics import BLEU

    preds = ["猫在垫子上 12.5 度", "hello。world 你好", "ＡＢＣ 你好"]
    targets = [["猫在垫子上有 12.5 度"], ["hello 。 world 你好"], ["ＡＢＣ 你好"]]
    want = BLEU(tokenize="zh").corpus_score(preds, [[t[0] for t in targets]]).score / 100.0
    _close(port_text.sacre_bleu_score(preds, targets, tokenize="zh", device="cpu"), want, atol=1e-5)
    with pytest.raises(ValueError, match="tokenize"):
        mt.SacreBLEUScore(tokenize="moses", device="cpu")


@pytest.mark.parametrize("n_word_order", [0, 2])
def test_chrf_vs_sacrebleu_single_ref(n_word_order):
    from sacrebleu.metrics import CHRF

    single = [[refs[0]] for refs in MT_TARGETS]
    want = CHRF(word_order=n_word_order, eps_smoothing=True).corpus_score(MT_PREDS, [[r[0] for r in single]])
    got = port_text.chrf_score(MT_PREDS, single, n_word_order=n_word_order, device="cpu")
    _close(got, want.score / 100.0, atol=1e-4)
    _close(got, jax_text.chrf_score(MT_PREDS, single, n_word_order=n_word_order))


def test_chrf_golden_sentence_scores_and_arguments():
    got = port_text.chrf_score(["the cat is on the mat"], [["there is a cat on the mat", "a cat is on the mat"]],
                               device="cpu")
    _close(got, 0.8640, atol=1e-3)
    score, sentences = port_text.chrf_score(MT_PREDS, MT_TARGETS, return_sentence_level_score=True, device="cpu")
    want_score, want_sentences = jax_text.chrf_score(MT_PREDS, MT_TARGETS, return_sentence_level_score=True)
    assert sentences.shape == (len(MT_PREDS),) and float(sentences[2]) > 0.9
    assert_bitwise(sentences, np.asarray(want_sentences), "sentence scores")
    _close(score, want_score)
    for bad in (dict(n_char_order=0), dict(n_word_order=-1), dict(beta=-1.0)):
        with pytest.raises(ValueError):
            port_text.chrf_score(MT_PREDS, MT_TARGETS, device="cpu", **bad)
        with pytest.raises(ValueError):
            mt.CHRFScore(device="cpu", **bad)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("lowercase", [False, True])
def test_ter_vs_sacrebleu_single_ref(normalize, lowercase):
    from sacrebleu.metrics import TER

    want = TER(normalized=normalize, case_sensitive=not lowercase).corpus_score(
        MT_PREDS, [[refs[0] for refs in MT_TARGETS]]).score / 100.0
    got = port_text.translation_edit_rate(MT_PREDS, [[refs[0]] for refs in MT_TARGETS], normalize=normalize,
                                          lowercase=lowercase, device="cpu")
    _close(got, want, atol=1e-5)


def test_ter_vs_sacrebleu_multi_ref_golden_and_shifts():
    from sacrebleu.metrics import TER

    padded = [refs + [refs[0]] * (len(_transposed_refs()) - len(refs)) for refs in MT_TARGETS]
    want = TER().corpus_score(MT_PREDS, _transposed_refs()).score / 100.0
    _close(port_text.translation_edit_rate(MT_PREDS, padded, device="cpu"), want, atol=1e-5)
    _close(port_text.translation_edit_rate(["the cat is on the mat"], [["there is a cat on the mat",
                                                                        "a cat is on the mat"]], device="cpu"),
           0.1538, atol=1e-4)
    _close(port_text.translation_edit_rate(["b c d e a"], [["a b c d e"]], device="cpu"), 1 / 5)
    with pytest.raises(ValueError, match="boolean"):
        mt.TranslationEditRate(normalize=1, device="cpu")


# --------------------------------------------------------------------------- #
# ROUGE, SQuAD, EED
# --------------------------------------------------------------------------- #
R_PREDS = ["the cat was found under the bed", "my life is a drama", "the quick brown fox jumps over the lazy dog"]
R_TARGETS = ["the cat was under the bed", "my life is a mess and a drama", "a quick brown fox jumped over lazy dogs"]
ROUGE_KEYS = ("rouge1", "rouge2", "rougeL", "rougeLsum")


def _oracle_rouge(preds, targets, use_stemmer=False):
    from rouge_score.rouge_scorer import RougeScorer

    scorer = RougeScorer(list(ROUGE_KEYS), use_stemmer=use_stemmer)
    per_sentence = [scorer.score(t, p) for p, t in zip(preds, targets)]
    out = {}
    for key in ROUGE_KEYS:
        for score in ("precision", "recall", "fmeasure"):
            out[f"{key}_{score}"] = np.mean([getattr(s[key], score) for s in per_sentence])
    return out


@pytest.mark.parametrize("use_stemmer", [False, True])
def test_rouge_vs_rouge_score(use_stemmer):
    want = _oracle_rouge(R_PREDS, R_TARGETS, use_stemmer=use_stemmer)
    got = port_text.rouge_score(R_PREDS, R_TARGETS, use_stemmer=use_stemmer, rouge_keys=ROUGE_KEYS, device="cpu")
    for key, val in want.items():
        _close(got[key], val, err_msg=key)
    jax_got = jax_text.rouge_score(R_PREDS, R_TARGETS, use_stemmer=use_stemmer, rouge_keys=ROUGE_KEYS)
    assert set(got) == set(jax_got)
    for key in jax_got:
        _close(got[key], jax_got[key])


@pytest.mark.parametrize("kw", [{}, {"accumulate": "avg"}, {"rouge_keys": ("rouge1", "rougeLsum")},
                                {"use_stemmer": True, "rouge_keys": "rougeL"}])
def test_rouge_module_matches_jax(kw):
    calls = [(R_PREDS[:2], R_TARGETS[:2]),
             (["First sentence here. A second one!", "one more. and the last"],
              [["first sentence there. a second", "First sentence here."], ["one more.", "and then the last"]])]
    if kw.get("accumulate") != "avg":
        calls = calls[:1] + [(R_PREDS[2:], R_TARGETS[2:])]
    _feed_pair("ROUGEScore", calls, **kw)


def test_rouge_multi_reference_and_keys():
    best = port_text.rouge_score(["the cat is on the mat"], [["a cat sat on a mat", "the cat is on the mat"]],
                                 accumulate="best", rouge_keys="rouge1", device="cpu")
    _close(best["rouge1_fmeasure"], 1.0)
    avg = port_text.rouge_score(["the cat is on the mat"], [["the cat is on the mat", "the cat is on the mat"]],
                                accumulate="avg", rouge_keys="rouge1", device="cpu")
    _close(avg["rouge1_fmeasure"], 1.0)
    with pytest.raises(ValueError):
        port_text.rouge_score(R_PREDS, R_TARGETS, rouge_keys="rouge42", device="cpu")
    with pytest.raises(ValueError):
        mt.ROUGEScore(accumulate="median", device="cpu")


def test_rouge_pickle_roundtrip_with_stemmer():
    import pickle

    metric = mt.ROUGEScore(use_stemmer=True, rouge_keys="rouge1", device="cpu")
    metric.update(R_PREDS, R_TARGETS)
    metric2 = pickle.loads(pickle.dumps(metric))
    _close(metric2.compute()["rouge1_fmeasure"], metric.compute()["rouge1_fmeasure"])


def test_rouge_stemmer_needs_nltk(monkeypatch):
    from metrics_tpu_torch.ops.text import rouge as rouge_ops

    monkeypatch.setattr(rouge_ops, "_NLTK_AVAILABLE", False)
    with pytest.raises(ModuleNotFoundError, match="nltk"):
        port_text.rouge_score(R_PREDS, R_TARGETS, use_stemmer=True, device="cpu")
    with pytest.raises(ModuleNotFoundError, match="nltk"):
        mt.ROUGEScore(use_stemmer=True, device="cpu")


def test_rouge_never_downloads(monkeypatch):
    """The splitter looks for punkt's data on this machine only; without it
    the regex splitter runs, and nltk.download is never called."""
    import nltk

    from metrics_tpu_torch.ops.text import rouge as rouge_ops

    def refuse(*args, **kwargs):
        raise AssertionError("nltk.download was called")

    monkeypatch.setattr(nltk, "download", refuse)
    rouge_ops._punkt_available.cache_clear()
    try:
        try:
            nltk.data.find("tokenizers/punkt_tab")
            has_punkt = True
        except LookupError:
            has_punkt = False
        assert rouge_ops._punkt_available() is has_punkt
        if not has_punkt:
            assert rouge_ops._split_sentence("One. Two!  Three? four") == ["One.", "Two!", "Three?", "four"]
    finally:
        rouge_ops._punkt_available.cache_clear()
    for path in pathlib.Path(mt.__file__).parent.rglob("*.py"):
        assert "nltk.download" not in path.read_text(), path


SQUAD_CASES = [
    ([{"prediction_text": "1976", "id": "56e10a3be3433e1400422b22"}],
     [{"answers": {"answer_start": [97], "text": ["1976"]}, "id": "56e10a3be3433e1400422b22"}]),
    ({"prediction_text": "big red cat", "id": "1"}, {"answers": {"answer_start": [0], "text": ["big cat"]}, "id": "1"}),
    ({"prediction_text": "Paris", "id": "q"}, {"answers": {"answer_start": [0, 5], "text": ["London", "Paris"]}, "id": "q"}),
    ([{"prediction_text": "The Big, red cat!", "id": "a"}, {"prediction_text": "", "id": "b"}],
     [{"answers": {"text": ["big red cat", "a cat"]}, "id": "a"}, {"answers": {"text": ["x"]}, "id": "b"},
      {"answers": {"text": ["unanswered"]}, "id": "c"}]),
]


@pytest.mark.parametrize("case", range(len(SQUAD_CASES)))
def test_squad_matches_jax(case):
    preds, target = SQUAD_CASES[case]
    got, want = port_text.squad(preds, target, device="cpu"), jax_text.squad(preds, target)
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key])
    _feed_pair("SQuAD", [(preds, target)])


def test_squad_values_and_errors():
    got = port_text.squad(*SQUAD_CASES[1], device="cpu")
    assert float(got["exact_match"]) == 0.0
    _close(got["f1"], 80.0, atol=1e-4)
    metric = mt.SQuAD(device="cpu")
    metric.update({"prediction_text": "a", "id": "1"}, {"answers": {"text": ["a"]}, "id": "1"})
    metric.update({"prediction_text": "b", "id": "2"}, {"answers": {"text": ["c"]}, "id": "2"})
    _close(metric.compute()["exact_match"], 50.0)
    assert metric.total.dtype == torch.int32 and int(metric.total) == 2
    with pytest.raises(KeyError):
        port_text.squad({"wrong": "x", "id": "1"}, {"answers": {"text": ["a"]}, "id": "1"}, device="cpu")
    with pytest.raises(KeyError):
        port_text.squad({"prediction_text": "x", "id": "1"}, {"id": "1"}, device="cpu")


E_PREDS = ["this is the prediction", "here is an other sample"]
E_TARGET = ["this is the reference", "here is another one"]


def test_eed_golden_and_properties():
    got = port_text.extended_edit_distance(E_PREDS, E_TARGET, device="cpu")
    _close(got, 0.3078, atol=1e-4)
    _close(got, jax_text.extended_edit_distance(E_PREDS, E_TARGET))
    same = float(port_text.extended_edit_distance(["same text"], [["same text"]], device="cpu"))
    assert 0.0 < same < 0.05
    best = float(port_text.extended_edit_distance(["good morning"], [["good morning", "totally different"]],
                                                  device="cpu"))
    assert best == float(port_text.extended_edit_distance(["good morning"], [["good morning"]], device="cpu"))
    ja = float(port_text.extended_edit_distance(["こんにちは"], [["こんにちは"]], language="ja", device="cpu"))
    assert 0.0 <= ja < 0.1
    with pytest.raises(ValueError):
        port_text.extended_edit_distance(["a"], [["b"]], alpha=-1.0, device="cpu")
    with pytest.raises(ValueError):
        mt.ExtendedEditDistance(language="de", device="cpu")


@pytest.mark.parametrize("kw", [{}, {"return_sentence_level_score": True}, {"alpha": 1.5, "rho": 0.1}])
def test_eed_module_matches_jax(kw):
    _, port = _feed_pair("ExtendedEditDistance", [(E_PREDS[:1], [[E_TARGET[0]]]), (E_PREDS[1:], [[E_TARGET[1]]])], **kw)
    args = {k: v for k, v in kw.items() if k != "return_sentence_level_score"}
    _close(port.compute()[0] if kw.get("return_sentence_level_score") else port.compute(),
           port_text.extended_edit_distance(E_PREDS, E_TARGET, device="cpu", **args))


def test_text_state_lists_are_device_tensors_and_functionals_default_to_cuda():
    port = mt.ROUGEScore(rouge_keys="rouge1", device="cpu")
    port.update(R_PREDS, R_TARGETS)
    assert all(isinstance(v, torch.Tensor) and v.shape == () for v in port.rouge1_fmeasure)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_text.word_error_rate(PREDS, TARGET)
        with pytest.raises(RuntimeError, match="CUDA"):
            mt.BLEUScore()
