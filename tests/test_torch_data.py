"""The port's data layer, evaluator and templates (copies of the JAX
package's framework-neutral modules, ``torch.distributed`` for the
evaluator's cross-process summary) against the JAX package's: the same
inputs and seeds give the same metrics, prompts, answers, shards, archives
and summaries, exactly. Tokenizer-free, through a reversible whitespace
tokenizer (``tests/test_data.py``'s)."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from shadowkv_tpu.data import longbench as j_lb
from shadowkv_tpu.data import metrics as j_metrics
from shadowkv_tpu.data import niah as j_niah
from shadowkv_tpu.data.dataset import Dataset as JDataset
from shadowkv_tpu.data.dataset import middle_truncate as j_trunc
from shadowkv_tpu.data.ruler import generate as j_gen
from shadowkv_tpu.eval.evaluator import DistConfig as JDist
from shadowkv_tpu.eval.evaluator import Evaluator as JEvaluator
from shadowkv_tpu.models import prompt_templates as j_tpl
from shadowkv_tpu_torch.data import longbench as t_lb
from shadowkv_tpu_torch.data import metrics as t_metrics
from shadowkv_tpu_torch.data import niah as t_niah
from shadowkv_tpu_torch.data.dataset import Dataset as TDataset
from shadowkv_tpu_torch.data.dataset import middle_truncate as t_trunc
from shadowkv_tpu_torch.data.ruler import generate as t_gen
from shadowkv_tpu_torch.eval.evaluator import DistConfig as TDist
from shadowkv_tpu_torch.eval.evaluator import Evaluator as TEvaluator
from shadowkv_tpu_torch.models import prompt_templates as t_tpl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: these toy-sized ops gain nothing from more, and
    under the suite's parallel workers the spinning thread pools of every
    worker slow each small op by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeTokenizer:
    """Reversible whitespace tokenizer for offline tests."""

    name_or_path = "fake-llama-3"

    def __init__(self):
        self.vocab: dict[str, int] = {}
        self.words: list[str] = []

    def encode(self, text, add_special_tokens=False, **kw):
        ids = []
        for w in text.split(" "):
            if w not in self.vocab:
                self.vocab[w] = len(self.words)
                self.words.append(w)
            ids.append(self.vocab[w])
        return ids

    def decode(self, ids, skip_special_tokens=False):
        return " ".join(self.words[i] for i in ids)


PREDICTIONS = [
    ("The number is 1234567.", "1234567"),
    ("nope 999", "1234567"),
    ("Paris<|eot_id|>", ["paris"]),
    ("It is Paris, yes", ["Paris", "Rome"]),
    ("I saw 11 and 22", ["11", "22"]),
    ("only 11\n\nand more", ["11", "22"]),
    ("apple banana", ["apple", "kiwi"]),
    ("  The   apple, an answer!  ", ["apple"]),
    ("", ["x"]),
]


@pytest.mark.parametrize("key", sorted(j_metrics.METRICS_FN))
def test_metrics_table(key):
    jf, tf = j_metrics.METRICS_FN[key], t_metrics.METRICS_FN[key]
    for pred, gt in PREDICTIONS:
        if key == "niah" and isinstance(gt, list):
            gt = gt[0]
        assert tf(pred, gt) == jf(pred, gt), (key, pred, gt)
    for name in ("ruler/niah_single_1", "ruler/niah_multiquery", "ruler/qa_2",
                 "ruler/vt", "ruler/cwe", "niah"):
        assert t_metrics.gen_len_for(name) == j_metrics.gen_len_for(name)
        assert (t_metrics.metric_for(name).__name__
                == j_metrics.metric_for(name).__name__)
    assert (t_metrics.normalize_answer(PREDICTIONS[7][0])
            == j_metrics.normalize_answer(PREDICTIONS[7][0]))


@pytest.mark.parametrize("task", sorted(j_gen.TASK_CONFIGS))
def test_ruler_task_matches_jax(task):
    """Same seed and tokenizer: the same prompts and answers."""
    kw = dict(seed=3, model_template=j_tpl.CTX_TEMPLATES["llama-3"])
    js = j_gen.generate_task(task, FakeTokenizer(), 512, 2, **kw)
    ts = t_gen.generate_task(task, FakeTokenizer(), 512, 2, **kw)
    assert ts == js


def test_templates_equal():
    for name in ("CTX_TEMPLATES", "CHAT_TEMPLATES", "PREFIX_TEMPLATES",
                 "STOP_STRINGS"):
        assert getattr(t_tpl, name) == getattr(j_tpl, name), name
    for model in ("meta-llama/Meta-Llama-3.1-8B-Instruct", "01-ai/Yi-9B-200K",
                  "THUDM/glm-4-9b-chat-1m", "Qwen/Qwen2-7B-Instruct",
                  "microsoft/Phi-3-mini-128k-instruct", "gpt2"):
        assert t_tpl.template_family(model) == j_tpl.template_family(model)


def test_middle_truncate():
    ids = np.arange(11)
    for n in (4, 5, 11, 20):
        np.testing.assert_array_equal(t_trunc(ids, n), j_trunc(ids, n))


@pytest.mark.parametrize("name, datalen, bucket, rank, world", [
    ("ruler/niah_single_1", 8192, 0, 0, 1),
    ("ruler/vt", 4096, 512, 1, 2),
    ("niah", 2048, 128, 1, 2),
])
def test_dataset_matches_jax(name, datalen, bucket, rank, world):
    """Prompts, answers, buckets and shards (RULER shards on ``shard``,
    NIAH at construction)."""
    kw = dict(num_samples=4, rank=rank, world_size=world, bucket=bucket)
    jd = JDataset(name, FakeTokenizer(), datalen, **kw)
    td = TDataset(name, FakeTokenizer(), datalen, **kw)
    for d in (jd, td):
        d.shard(rank, world)
    assert len(td) == len(jd) and td.gen_len == jd.gen_len
    assert td.gt == jd.gt
    assert (td.ctx_len, td.depth_pct) == (jd.ctx_len, jd.depth_pct)
    for a, b in zip(td.tokenized_prompts, jd.tokenized_prompts):
        np.testing.assert_array_equal(a, b)
        assert not bucket or len(a) % bucket == 0


def test_niah_grid_and_infinibench_prompt():
    kw = dict(max_context=2048, min_context=512, n_context_intervals=3,
              n_depth_intervals=3, seed=0)
    js = j_niah.build_niah_grid(FakeTokenizer(), **kw)
    ts = t_niah.build_niah_grid(FakeTokenizer(), **kw)
    assert ts == js and len(ts) == 9
    examples = [
        (dict(input='Find the key "abc123" here', context="{...}"),
         "kv_retrieval"),
        (dict(input="compute func_3(7) now", context="def func_3(x): ..."),
         "code_run"),
        (dict(input="Q?", context="book", options=["a", "b", "c", "d"]),
         "longbook_choice_eng"),
    ]
    for ex, task in examples:
        assert (t_lb.infini_bench_prompt(ex, task)
                == j_lb.infini_bench_prompt(ex, task))


class EchoLLM:
    """Replies with the answers it is given, one step at a time."""

    model_name = "echo"
    batch_size = 1

    def __init__(self, answers):
        self.answers = list(answers)
        self.calls = 0

    def generate(self, batch, gen_len=0, temperature=0.0, top_p=1.0):
        out = [self.answers[self.calls]]
        self.calls += 1
        return out


def _archive_and_resume(Dataset, Evaluator, DistConfig, out):
    """A 4-sample run interrupted after 2 steps (plus a torn line), then
    resumed: (scores, calls, archive lines, summary table)."""
    tok = FakeTokenizer()
    ds = Dataset("ruler/niah_single_1", tok, 8192, num_samples=4, bucket=0)
    answers = [g if isinstance(g, str) else g[0] for g in ds.gt]
    answers[1] = "wrong"
    ev = Evaluator(DistConfig(False, 0, 1, True))
    part = Dataset("ruler/niah_single_1", tok, 8192, num_samples=2, bucket=0)
    part.tokenized_prompts, part.gt = ds.tokenized_prompts[:2], ds.gt[:2]
    first = ev.test(EchoLLM(answers), part, out)
    with open(out, "a") as f:
        f.write('{"prediction": ["torn')
    llm = EchoLLM(answers[2:])
    second = ev.test(llm, ds, out, resume=True)
    with open(out) as f:
        lines = [json.loads(line) for line in f]
    return (first, second), llm.calls, lines, ev.summarize()


def test_evaluator_archive_and_resume_match_jax(tmp_path):
    j = _archive_and_resume(JDataset, JEvaluator, JDist,
                            str(tmp_path / "j.jsonl"))
    t = _archive_and_resume(TDataset, TEvaluator, TDist,
                            str(tmp_path / "t.jsonl"))
    assert t == j
    assert t[0] == (0.5, 0.75) and t[1] == 2 and len(t[2]) == 4
    assert set(t[2][0]) == {"prediction", "ground_truth", "correct",
                            "avg_score"}


_WORKER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {repo!r})
    from shadowkv_tpu_torch.eval.evaluator import (
        Evaluator, close_dist, init_dist)
    dist = init_dist()
    assert dist.is_distributed and dist.world_size == 2
    ev = Evaluator(dist)
    pid = dist.rank
    ev.all_stats.append(dict(model="m", dataset="d", samples=2 + pid,
                             setting="s", score=1.0 if pid == 0 else 0.5))
    table = ev.summarize()
    if dist.master_process:
        # weighted mean: (2*1.0 + 3*0.5) / 5 = 0.7
        assert table and "0.7000" in table, table
        print("TABLE_OK")
    close_dist(dist)
""")


def test_two_process_gloo_summary(tmp_path):
    """``init_dist`` from torchrun's variables, gloo on the CPU, and the
    sample-weighted summary over ``all_gather``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=ROOT))
    procs = []
    for rank in (1, 0):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), CUDA_VISIBLE_DEVICES="")
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, env=env, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=60))
    except subprocess.TimeoutExpired:
        pytest.fail("gloo summary workers timed out after 60 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    assert any("TABLE_OK" in out for out, _ in outs)
