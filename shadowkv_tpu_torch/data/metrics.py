"""Scoring metrics for the accuracy harness.

Behavioral parity with the reference metrics (reference
data/metrics.py:21-88): same normalization, same containment rules, so
scores are directly comparable with the reference's published RULER /
NIAH gaps. All functions take (prediction: str, ground_truth) and
return a float in [0, 1].
"""

from __future__ import annotations

import re
import string

_ARTICLES = re.compile(r"\b(a|an|the)\b")
_NON_PRINTABLE = re.compile(r"[\x00-\x1f]")
_PUNCT = set(string.punctuation)


def normalize_answer(text: str) -> str:
    """Lowercase, strip punctuation/articles, collapse whitespace
    (reference data/metrics.py:21-37)."""
    text = text.lower()
    text = "".join(ch for ch in text if ch not in _PUNCT)
    text = _ARTICLES.sub(" ", text)
    return " ".join(text.split())


def postprocess_pred(pred: str) -> str:
    """Strip model stop-token residue and control characters
    (reference data/metrics.py:40-48)."""
    pred = (
        pred.strip()
        .replace("<|eot_id|>", "")
        .replace("</s>", "")
        .replace("</s", "")
        .replace("</", "")
    )
    return _NON_PRINTABLE.sub("\n", pred).strip()


def needle_score(prediction: str, ground_truth: str) -> float:
    """NIAH: prefix exact-match after normalization, or the ground truth
    appearing as a whole token (reference data/metrics.py:78-88)."""
    pred = normalize_answer(postprocess_pred(prediction))
    gt = normalize_answer(ground_truth)
    score = float(pred[: len(gt)] == gt)
    return max(score, float(gt in pred.split()))


def string_match_part(prediction: str, refs) -> float:
    """QA: symmetric substring containment over candidate answers
    (reference data/metrics.py:50-57)."""
    pred = postprocess_pred(prediction).lower()
    if isinstance(refs, str):
        refs = [refs]
    refs = [r.lower() for r in refs]
    ref_in_pred = max((1.0 if r in pred else 0.0) for r in refs)
    pred_in_ref = max((1.0 if pred in r else 0.0) for r in refs)
    return round(max(ref_in_pred, pred_in_ref), 2)


def multi_number(prediction: str, ground_truth: list) -> float:
    """Multi-value/-query NIAH: hit rate of the numeric answers among
    all numbers in the prediction (reference data/metrics.py:59-67)."""
    pred_numbers = re.findall(r"\d+", normalize_answer(prediction))
    hits = [g for g in ground_truth if g in pred_numbers]
    return len(hits) / len(ground_truth)


def multi_words(prediction: str, ground_truth: list) -> float:
    """VT/CWE/FWE: hit rate of answer words among the prediction's
    word tokens (reference data/metrics.py:69-76)."""
    pred_words = re.findall(r"\b\w+\b", prediction.lower())
    gts = [g.lower() for g in ground_truth]
    hits = [g for g in gts if g in pred_words]
    return len(hits) / len(ground_truth)


METRICS_FN = {
    "niah": needle_score,
    "multi": multi_number,
    "vt": multi_words,
    "cwe": multi_words,
    "fwe": multi_words,
    "qa": string_match_part,
}

# Tokens the model is asked to generate per task family (reference
# data/dataset.py:38-44,91-105).
GEN_LEN = {
    "niah": 128,  # ruler/niah_* tasks (the bare 'niah' sweep uses 10)
    "vt": 30,
    "cwe": 120,
    "fwe": 50,
    "qa": 32,
}


def metric_for(dataset_name: str):
    """Task-name -> metric dispatch (reference data/dataset.py:112-126)."""
    name = dataset_name
    if "multiquery" in name or "multivalue" in name:
        return METRICS_FN["multi"]
    for key in ("niah", "vt", "cwe", "fwe", "qa"):
        if key in name:
            return METRICS_FN[key]
    raise ValueError(f"no metric for dataset '{dataset_name}'")


def gen_len_for(dataset_name: str) -> int:
    """Task-name -> generation length (reference data/dataset.py:91-105)."""
    if dataset_name == "niah":
        return 10
    for key in ("niah", "vt", "cwe", "fwe", "qa"):
        if key in dataset_name:
            return 128 if key == "niah" else GEN_LEN[key]
    raise ValueError(f"no gen_len for dataset '{dataset_name}'")
