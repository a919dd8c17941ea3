"""RULER-equivalent synthetic long-context task generators.

Rebuild of the vendored NVIDIA RULER generators the reference ships
(reference data/ruler/synthetic/{niah,variable_tracking,
common_words_extraction,freq_words_extraction,qa}.py and
synthetic.yaml), self-contained for an offline environment:

- word lists come from :mod:`shadowkv_tpu_torch.data.wordlists` instead of
  ``wonderwords``;
- the 'essay' haystack is synthesized filler prose instead of a
  downloaded Paul Graham corpus;
- QA distractor documents come from local squad/hotpotqa JSON dumps when
  present (same paths as the reference, data/ruler/synthetic/json/) and
  fall back to synthetic fact documents otherwise.

Sample schema matches the reference jsonl
(``{"index", "input", "outputs", "length", ...}``) so downstream
``Dataset``/``Evaluator`` behave identically.

Context sizing: the reference grows the haystack incrementally,
re-tokenizing the full prompt each step (niah.py generate_samples); here
a chars-per-token estimate is refined by bisection with a handful of
tokenizer calls per task/length, which is orders of magnitude faster at
128K+ tokens and lands within the same "<= max_seq_length" contract.
"""

from __future__ import annotations

import json
import os
import random
import re
from typing import Callable, Optional

from shadowkv_tpu_torch.data import wordlists as wl

# ---------------------------------------------------------------------------
# Task registry (reference data/ruler/synthetic.yaml + constants.py)
# ---------------------------------------------------------------------------

NIAH_TEMPLATE = (
    "Some special magic {type_needle_v} are hidden within the following "
    "text. Make sure to memorize it. I will quiz you about the "
    "{type_needle_v} afterwards.\n{context}\nWhat are all the special magic "
    "{type_needle_v} for {query} mentioned in the provided text?"
)
NIAH_ANSWER_PREFIX = (
    " The special magic {type_needle_v} for {query} mentioned in the "
    "provided text are"
)

VT_TEMPLATE = (
    "Memorize and track the chain(s) of variable assignment hidden in the "
    "following text.\n\n{context}\nQuestion: Find all variables that are "
    "assigned the value {query} in the text above."
)
VT_ANSWER_PREFIX = (
    " Answer: According to the chain(s) of variable assignment in the text "
    "above, {num_v} variables are assgined the value {query}, they are: "
)

CWE_TEMPLATE = (
    "Below is a numbered list of words. In these words, some appear more "
    "often than others. Memorize the ones that appear most often.\n"
    "{context}\nQuestion: What are the 10 most common words in the above "
    "list?"
)
CWE_ANSWER_PREFIX = (
    " Answer: The top 10 words that appear most often in the list are:"
)

FWE_TEMPLATE = (
    "Read the following coded text and track the frequency of each coded "
    "word. Find the three most frequently appeared coded words. {context}\n"
    "Question: Do not provide any explanation. Please ignore the dots "
    "'....'. What are the three most frequently appeared words in the "
    "above coded text?"
)
FWE_ANSWER_PREFIX = (
    " Answer: According to the coded text above, the three most frequently "
    "appeared words are:"
)

QA_TEMPLATE = (
    "Answer the question based on the given documents. Only give me the "
    "answer and do not output any other words.\n\nThe following are given "
    "documents.\n\n{context}\n\nAnswer the question based on the given "
    "documents. Only give me the answer and do not output any other "
    "words.\n\nQuestion: {query}"
)
QA_ANSWER_PREFIX = " Answer:"

TASK_CONFIGS: dict[str, dict] = {
    "niah_single_1": dict(task="niah", type_haystack="repeat",
                          type_needle_k="words", type_needle_v="numbers",
                          num_needle_k=1, num_needle_v=1, num_needle_q=1),
    "niah_single_2": dict(task="niah", type_haystack="essay",
                          type_needle_k="words", type_needle_v="numbers",
                          num_needle_k=1, num_needle_v=1, num_needle_q=1),
    "niah_single_3": dict(task="niah", type_haystack="essay",
                          type_needle_k="words", type_needle_v="uuids",
                          num_needle_k=1, num_needle_v=1, num_needle_q=1),
    "niah_multikey_1": dict(task="niah", type_haystack="essay",
                            type_needle_k="words", type_needle_v="numbers",
                            num_needle_k=4, num_needle_v=1, num_needle_q=1),
    "niah_multikey_2": dict(task="niah", type_haystack="needle",
                            type_needle_k="words", type_needle_v="numbers",
                            num_needle_k=1, num_needle_v=1, num_needle_q=1),
    "niah_multikey_3": dict(task="niah", type_haystack="needle",
                            type_needle_k="uuids", type_needle_v="uuids",
                            num_needle_k=1, num_needle_v=1, num_needle_q=1),
    "niah_multivalue": dict(task="niah", type_haystack="essay",
                            type_needle_k="words", type_needle_v="numbers",
                            num_needle_k=1, num_needle_v=4, num_needle_q=1),
    "niah_multiquery": dict(task="niah", type_haystack="essay",
                            type_needle_k="words", type_needle_v="numbers",
                            num_needle_k=1, num_needle_v=1, num_needle_q=4),
    "vt": dict(task="vt", num_chains=1, num_hops=4),
    "cwe": dict(task="cwe", freq_cw=30, freq_ucw=3, num_cw=10),
    "fwe": dict(task="fwe", alpha=2.0),
    "qa_1": dict(task="qa", dataset="squad"),
    "qa_2": dict(task="qa", dataset="hotpotqa"),
}

TOKENS_TO_GENERATE = {"niah": 128, "vt": 30, "cwe": 120, "fwe": 50, "qa": 32}

NEEDLE = (
    "One of the special magic {type_needle_v} for {key} is: {value}."
)

_REPEAT_NOISE = (
    "The grass is green. The sky is blue. The sun is yellow. "
    "Here we go. There and back again."
)


def _token_len(tokenizer, text: str) -> int:
    return len(tokenizer.encode(text, add_special_tokens=False))


def _singularize(template: str) -> str:
    """Reference's single-answer grammar fixups
    (data/ruler/synthetic/niah.py:182-188)."""
    template = template.replace("Some", "A")
    template = template.replace("are all", "is")
    template = template.replace("are", "is")
    template = template.replace("answers", "answer")
    return template


def _calibrate(build: Callable[[int], str], tokenizer, max_tokens: int,
               lo: int, hi: int) -> int:
    """Largest size n in [lo, hi] with token_len(build(n)) <= max_tokens."""
    best = lo
    while lo <= hi:
        mid = (lo + hi) // 2
        if _token_len(tokenizer, build(mid)) <= max_tokens:
            best = mid
            lo = mid + 1
        else:
            hi = mid - 1
    return best


# ---------------------------------------------------------------------------
# NIAH family (reference data/ruler/synthetic/niah.py)
# ---------------------------------------------------------------------------


def _gen_needle_value(rng: random.Random, kind: str) -> str:
    if kind == "numbers":
        return wl.random_number(rng)
    if kind == "words":
        return rng.choice(wl.adjective_noun_words())
    if kind == "uuids":
        return wl.random_uuid(rng)
    raise ValueError(kind)


def _niah_sample(cfg: dict, rng: random.Random, num_units: int,
                 model_template: str) -> dict:
    tnv = cfg["type_needle_v"]
    # At least as many keys as queries (reference niah.py:71).
    num_k = max(cfg["num_needle_k"], cfg["num_needle_q"])
    keys, values, needles = [], [], []
    for _ in range(num_k):
        keys.append(_gen_needle_value(rng, cfg["type_needle_k"]))
        vals = []
        for _ in range(cfg["num_needle_v"]):
            vals.append(_gen_needle_value(rng, tnv))
            needles.append(
                NEEDLE.format(type_needle_v=tnv, key=keys[-1], value=vals[-1])
            )
        values.append(vals)
    rng.shuffle(needles)

    if cfg["type_haystack"] == "essay":
        text = wl.synthetic_essay(rng, num_units)
        sents = re.split(r"(?<=\.)\s+", text)
    elif cfg["type_haystack"] == "repeat":
        sents = [_REPEAT_NOISE] * num_units
    elif cfg["type_haystack"] == "needle":
        sents = [
            NEEDLE.format(
                type_needle_v=tnv,
                key=_gen_needle_value(rng, cfg["type_needle_k"]),
                value=_gen_needle_value(rng, tnv),
            )
            for _ in range(num_units)
        ]
    else:
        raise ValueError(cfg["type_haystack"])

    positions = sorted(rng.sample(range(len(sents)), len(needles)),
                       reverse=True)
    for pos, ndl in zip(positions, needles):
        sents.insert(pos, ndl)
    joiner = " " if cfg["type_haystack"] == "essay" else "\n"
    context = joiner.join(sents)

    q_idx = rng.sample(range(num_k), cfg["num_needle_q"])
    queries = [keys[i] for i in q_idx]
    answers = [v for i in q_idx for v in values[i]]
    query = (
        ", ".join(queries[:-1]) + ", and " + queries[-1]
        if len(queries) > 1
        else queries[0]
    )

    template = NIAH_TEMPLATE + NIAH_ANSWER_PREFIX
    if cfg["num_needle_q"] * cfg["num_needle_v"] == 1:
        template = _singularize(template)
        tnv = tnv[:-1]
    task_input = template.format(
        type_needle_v=tnv, context=context, query=query
    )
    return dict(
        input=model_template.format(ctx=task_input),
        outputs=answers,
    )


def gen_niah(cfg, tokenizer, max_seq_length, num_samples, seed,
             model_template):
    rng = random.Random(seed)
    gen = TOKENS_TO_GENERATE["niah"]

    def build(n):
        return _niah_sample(cfg, random.Random(seed), n, model_template)[
            "input"
        ]

    unit_tokens = 26 if cfg["type_haystack"] == "repeat" else 12
    guess = max(8, max_seq_length // unit_tokens)
    num_units = _calibrate(
        build, tokenizer, max_seq_length - gen, guess // 4, guess * 3
    )
    samples = []
    for i in range(num_samples):
        s = _niah_sample(cfg, rng, num_units, model_template)
        s["index"] = i
        s["length"] = _token_len(tokenizer, s["input"]) + gen
        samples.append(s)
    return samples


# ---------------------------------------------------------------------------
# Variable tracking (reference data/ruler/synthetic/variable_tracking.py)
# ---------------------------------------------------------------------------


def _vt_sample(cfg: dict, rng: random.Random, num_noises: int,
               model_template: str) -> dict:
    chains_n, hops = cfg["num_chains"], cfg["num_hops"]
    names: list[str] = []
    while len(names) < chains_n * (hops + 1):
        name = "".join(
            rng.choice("ABCDEFGHIJKLMNOPQRSTUVWXYZ") for _ in range(5)
        )
        if name not in names:
            names.append(name)

    value = str(rng.randint(10000, 99999))
    chains, var_groups = [], []
    for c in range(chains_n):
        group = names[c * (hops + 1) : (c + 1) * (hops + 1)]
        var_groups.append(group)
        chain = [f"VAR {group[0]} = {value}"]
        for j in range(hops):
            chain.append(f"VAR {group[j + 1]} = VAR {group[j]} ")
        chains.append(chain)

    sents = [_REPEAT_NOISE + "\n"] * num_noises
    for chain in chains:
        positions = sorted(rng.sample(range(len(sents)), len(chain)))
        for off, (pos, stmt) in enumerate(zip(positions, chain)):
            sents.insert(pos + off, stmt)
    context = " ".join(sents).replace(". \n", ".\n")

    task_input = (VT_TEMPLATE + VT_ANSWER_PREFIX).format(
        context=context, query=value, num_v=hops + 1
    )
    return dict(
        input=model_template.format(ctx=task_input),
        outputs=var_groups[0],
    )


def gen_vt(cfg, tokenizer, max_seq_length, num_samples, seed,
           model_template):
    rng = random.Random(seed)
    gen = TOKENS_TO_GENERATE["vt"]

    def build(n):
        return _vt_sample(cfg, random.Random(seed), n, model_template)["input"]

    guess = max(8, max_seq_length // 26)
    num_noises = _calibrate(
        build, tokenizer, max_seq_length - gen, 4, guess * 2
    )
    samples = []
    for i in range(num_samples):
        s = _vt_sample(cfg, rng, num_noises, model_template)
        s["index"] = i
        s["length"] = _token_len(tokenizer, s["input"]) + gen
        samples.append(s)
    return samples


# ---------------------------------------------------------------------------
# Common words extraction (reference common_words_extraction.py)
# ---------------------------------------------------------------------------


def _cwe_sample(cfg: dict, rng: random.Random, num_words: int,
                model_template: str, is_short: bool) -> dict:
    words = wl.all_words()

    def example(n, rep_c, rep_u, num_c):
        picked = rng.sample(words, min(n, len(words)))
        common, uncommon = picked[:num_c], picked[num_c:]
        word_list = common * rep_c + uncommon * rep_u
        rng.shuffle(word_list)
        ctx = " ".join(f"{i + 1}. {w}" for i, w in enumerate(word_list))
        return ctx, common

    num_cw = cfg["num_cw"]
    if is_short:
        ctx_ex, ans_ex = example(20, 3, 1, num_cw)
        ctx, answer = example(num_words, 6, 1, num_cw)
    else:
        ctx_ex, ans_ex = example(40, 10, 3, num_cw)
        ctx, answer = example(
            num_words, cfg["freq_cw"], cfg["freq_ucw"], num_cw
        )

    template = CWE_TEMPLATE + CWE_ANSWER_PREFIX
    few_shot = template.format(context=ctx_ex, query="") + " ".join(
        f"{i + 1}. {w}" for i, w in enumerate(ans_ex)
    )
    task_input = few_shot + "\n" + template.format(context=ctx, query="")
    return dict(
        input=model_template.format(ctx=task_input),
        outputs=answer,
    )


def gen_cwe(cfg, tokenizer, max_seq_length, num_samples, seed,
            model_template):
    rng = random.Random(seed)
    gen = TOKENS_TO_GENERATE["cwe"]
    is_short = max_seq_length < 4096

    def build(n):
        return _cwe_sample(cfg, random.Random(seed), n, model_template,
                           is_short)["input"]

    reps = 6 + 1 if is_short else cfg["freq_cw"] // 3 + cfg["freq_ucw"]
    guess = max(20, max_seq_length // (4 * reps))
    num_words = _calibrate(
        build, tokenizer, max_seq_length - gen, 15, guess * 4
    )
    samples = []
    for i in range(num_samples):
        s = _cwe_sample(cfg, rng, num_words, model_template, is_short)
        s["index"] = i
        s["length"] = _token_len(tokenizer, s["input"]) + gen
        samples.append(s)
    return samples


# ---------------------------------------------------------------------------
# Frequent words extraction (reference freq_words_extraction.py)
# ---------------------------------------------------------------------------


def _zeta(alpha: float, n: int = 10000) -> float:
    return sum(k ** -alpha for k in range(1, n + 1))


def _fwe_sample(cfg: dict, rng: random.Random, num_words: int,
                vocab_size: int, model_template: str) -> dict:
    alpha = cfg["alpha"]
    vocab = set()
    while len(vocab) < vocab_size:
        vocab.add(
            "".join(rng.choice("abcdefghijklmnopqrstuvwxyz")
                    for _ in range(6))
        )
    vocab = sorted(vocab)
    rng.shuffle(vocab)
    vocab[0] = "..."  # top-ranked word is treated as noise

    z = _zeta(alpha)
    sampled = []
    for rank, w in enumerate(vocab, start=1):
        count = int(num_words * rank ** -alpha / z)
        sampled.extend([w] * count)
    rng.shuffle(sampled)

    task_input = (FWE_TEMPLATE + FWE_ANSWER_PREFIX).format(
        context=" ".join(sampled), query=""
    )
    return dict(
        input=model_template.format(ctx=task_input),
        outputs=vocab[1:4],
    )


def gen_fwe(cfg, tokenizer, max_seq_length, num_samples, seed,
            model_template):
    rng = random.Random(seed)
    gen = TOKENS_TO_GENERATE["fwe"]
    vocab_size = max(50, max_seq_length // 50)

    def build(n):
        return _fwe_sample(cfg, random.Random(seed), n, vocab_size,
                           model_template)["input"]

    guess = max(64, max_seq_length // 3)
    num_words = _calibrate(
        build, tokenizer, max_seq_length - gen, 32, guess * 4
    )
    samples = []
    for i in range(num_samples):
        s = _fwe_sample(cfg, rng, num_words, vocab_size, model_template)
        s["index"] = i
        s["length"] = _token_len(tokenizer, s["input"]) + gen
        samples.append(s)
    return samples


# ---------------------------------------------------------------------------
# QA over distractor documents (reference qa.py)
# ---------------------------------------------------------------------------

_QA_JSON_DIRS = [
    os.path.join(os.path.dirname(__file__), "json"),
    "data/ruler/json",
]

_DOCUMENT_PROMPT = "Document {i}:\n{document}"


def _load_qa_corpus(dataset: str) -> Optional[tuple[list, list]]:
    """Load (qas, docs) from a local squad/hotpotqa dump if present
    (same file layout as reference data/ruler/synthetic/qa.py:67-110)."""
    for d in _QA_JSON_DIRS:
        path = os.path.join(d, f"{dataset}.json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            data = json.load(f)
        if dataset == "squad":
            docs = sorted({
                p["context"] for d_ in data["data"] for p in d_["paragraphs"]
            })
            idx = {c: i for i, c in enumerate(docs)}
            qas = []
            for d_ in data["data"]:
                more = [idx[p["context"]] for p in d_["paragraphs"]]
                for p in d_["paragraphs"]:
                    for qa in p["qas"]:
                        if qa.get("is_impossible"):
                            continue
                        qas.append(dict(
                            query=qa["question"],
                            outputs=[a["text"] for a in qa["answers"]],
                            context=[idx[p["context"]]],
                            more_context=[
                                i for i in more if i != idx[p["context"]]
                            ],
                        ))
            return qas, docs
        else:  # hotpotqa
            docs = sorted({
                f"{t}\n{''.join(p)}" for d_ in data for t, p in d_["context"]
            })
            idx = {c: i for i, c in enumerate(docs)}
            qas = [
                dict(
                    query=d_["question"],
                    outputs=[d_["answer"]],
                    context=[
                        idx[f"{t}\n{''.join(p)}"] for t, p in d_["context"]
                    ],
                    more_context=[],
                )
                for d_ in data
            ]
            return qas, docs
    return None


def _synth_qa_corpus(rng: random.Random, n_docs: int = 4000):
    """Offline fallback: synthetic fact documents. Each document states
    a unique (city, attribute, value) fact inside filler prose; the
    question asks for the value."""
    attrs = ["postal code", "founding year", "tower height",
             "river length", "bridge count"]
    docs, qas = [], []
    for i in range(n_docs):
        city = rng.choice(wl.CITIES)
        attr = rng.choice(attrs)
        value = str(rng.randint(10000, 9999999))
        prose = wl.synthetic_essay(rng, 80)
        half = len(prose) // 2
        fact = f" The {attr} of {city} (record {i}) is {value}. "
        docs.append(prose[:half] + fact + prose[half:])
        qas.append(dict(
            query=(
                f"What is the {attr} of {city} according to record {i}?"
            ),
            outputs=[value],
            context=[i],
            more_context=[],
        ))
    return qas, docs


def _qa_sample(qas, docs, rng: random.Random, index: int, num_docs: int,
               model_template: str) -> dict:
    qa = qas[index % len(qas)]
    cur = list(qa["context"])
    more = list(qa.get("more_context", []))
    if num_docs < len(docs):
        need = num_docs - len(cur)
        if need > len(more):
            pool = [i for i in range(len(docs)) if i not in cur + more]
            chosen = cur + more + rng.sample(pool, max(0, need - len(more)))
        else:
            chosen = cur + rng.sample(more, need)
        all_docs = [docs[i] for i in chosen]
    else:
        all_docs = list(docs)
    rng.shuffle(all_docs)
    context = "\n\n".join(
        _DOCUMENT_PROMPT.format(i=i + 1, document=d)
        for i, d in enumerate(all_docs)
    )
    task_input = (QA_TEMPLATE + QA_ANSWER_PREFIX).format(
        context=context, query=qa["query"]
    )
    return dict(
        input=model_template.format(ctx=task_input),
        outputs=qa["outputs"],
    )


def gen_qa(cfg, tokenizer, max_seq_length, num_samples, seed,
           model_template):
    rng = random.Random(seed)
    gen = TOKENS_TO_GENERATE["qa"]
    corpus = _load_qa_corpus(cfg["dataset"])
    if corpus is None:
        corpus = _synth_qa_corpus(random.Random(seed))
    qas, docs = corpus

    def build(n):
        return _qa_sample(qas, docs, random.Random(seed), 0, n,
                          model_template)["input"]

    guess = max(2, max_seq_length // 150)
    num_docs = _calibrate(
        build, tokenizer, max_seq_length - gen, 1,
        min(len(docs), guess * 4),
    )
    samples = []
    order = list(range(len(qas)))
    rng.shuffle(order)
    for i in range(num_samples):
        s = _qa_sample(qas, docs, rng, order[i % len(order)], num_docs,
                       model_template)
        s["index"] = i
        s["length"] = _token_len(tokenizer, s["input"]) + gen
        samples.append(s)
    return samples


_GENERATORS = {
    "niah": gen_niah,
    "vt": gen_vt,
    "cwe": gen_cwe,
    "fwe": gen_fwe,
    "qa": gen_qa,
}


def generate_task(
    task_name: str,
    tokenizer,
    max_seq_length: int,
    num_samples: int,
    seed: int = 42,
    model_template: str = "{ctx}",
) -> list[dict]:
    """Generate ``num_samples`` jsonl-ready samples for a RULER task.

    ``model_template`` is the per-model chat wrapper (reference
    prepare.py wraps the task template with the model template before
    generation, data/ruler/prepare.py:91-97).
    """
    if task_name.startswith("ruler/"):
        task_name = task_name.split("/", 1)[1]
    cfg = TASK_CONFIGS[task_name]
    return _GENERATORS[cfg["task"]](
        cfg, tokenizer, max_seq_length, num_samples, seed, model_template
    )
