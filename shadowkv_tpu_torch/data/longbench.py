"""LongBench / InfiniteBench prompt assembly.

Parity with the reference template tables and prompt builders
(reference data/utils.py:145-303): per-task templates and the
InfiniteBench example-to-prompt assembly. Datasets load from local
jsonl/json dumps (zero-egress environment); pass the file path.
"""

from __future__ import annotations

import json
import re

LONG_BENCH_TEMPLATE = {
    "narrativeqa": (
        "You are given a story, which can be either a novel or a movie "
        "script, and a question. Answer the question asconcisely as you "
        "can, using a single phrase if possible. Do not provide any "
        "explanation.\n\nStory: {context}\n\nNow, answer the question "
        "based on the story asconcisely as you can, using a single "
        "phrase if possible. Do not provide any explanation.\n\n"
        "Question: {input}\n\nAnswer:"
    ),
    "qasper": (
        "You are given a scientific article and a question. Answer the "
        "question as concisely as you can, using a single phrase or "
        "sentence if possible. If the question cannot be answered based "
        "on the information in the article, write \"unanswerable\". If "
        "the question is a yes/no question, answer \"yes\", \"no\", or "
        "\"unanswerable\". Do not provide any explanation.\n\nArticle: "
        "{context}\n\n Answer the question based on the above article "
        "as concisely as you can, using a single phrase or sentence if "
        "possible. If the question cannot be answered based on the "
        "information in the article, write \"unanswerable\". If the "
        "question is a yes/no question, answer \"yes\", \"no\", or "
        "\"unanswerable\". Do not provide any explanation.\n\n"
        "Question: {input}\n\nAnswer:"
    ),
    "multifieldqa_en": (
        "Read the following text and answer briefly.\n\n{context}\n\n"
        "Now, answer the following question based on the above text, "
        "only give me the answer and do not output any other words.\n\n"
        "Question: {input}\nAnswer:"
    ),
    "hotpotqa": (
        "Answer the question based on the given passages. Only give me "
        "the answer and do not output any other words.\n\nThe following "
        "are given passages.\n{context}\n\nAnswer the question based on "
        "the given passages. Only give me the answer and do not output "
        "any other words.\n\nQuestion: {input}\nAnswer:"
    ),
    "2wikimqa": (
        "Answer the question based on the given passages. Only give me "
        "the answer and do not output any other words.\n\nThe following "
        "are given passages.\n{context}\n\nAnswer the question based on "
        "the given passages. Only give me the answer and do not output "
        "any other words.\n\nQuestion: {input}\nAnswer:"
    ),
    "gov_report": (
        "You are given a report by a government agency. Write a one-page "
        "summary of the report.\n\nReport:\n{context}\n\nNow, write a "
        "one-page summary of the report.\n\nSummary:"
    ),
    "qmsum": (
        "You are given a meeting transcript and a query containing a "
        "question or instruction. Answer the query in one or more "
        "sentences.\n\nTranscript:\n{context}\n\nNow, answer the query "
        "based on the above meeting transcript in one or more "
        "sentences.\n\nQuery: {input}\nAnswer:"
    ),
    "multi_news": (
        "You are given several news passages. Write a one-page summary "
        "of all news. \n\nNews:\n{context}\n\nNow, write a one-page "
        "summary of all the news.\n\nSummary:"
    ),
    "trec": (
        "Please determine the type of the question below. Here are some "
        "examples of questions.\n\n{context}\n{input}"
    ),
    "triviaqa": (
        "Answer the question based on the given passage. Only give me "
        "the answer and do not output any other words. The following "
        "are some examples.\n\n{context}\n\n{input}"
    ),
    "samsum": (
        "Summarize the dialogue into a few short sentences. The "
        "following are some examples.\n\n{context}\n\n{input}"
    ),
    "passage_count": (
        "There are some paragraphs below sourced from Wikipedia. Some "
        "of them may be duplicates. Please carefully read these "
        "paragraphs and determine how many unique paragraphs there are "
        "after removing duplicates. In other words, how many "
        "non-repeating paragraphs are there in total?\n\n{context}\n\n"
        "Please enter the final count of unique paragraphs after "
        "removing duplicates. The output format should only contain "
        "the number, such as 1, 2, 3, and so on.\n\nThe final answer "
        "is: "
    ),
    "passage_retrieval_en": (
        "Here are 30 paragraphs from Wikipedia, along with an abstract. "
        "Please determine which paragraph the abstract is from.\n\n"
        "{context}\n\nThe following is an abstract.\n\n{input}\n\n"
        "Please enter the number of the paragraph that the abstract is "
        "from. The answer format must be like \"Paragraph 1\", "
        "\"Paragraph 2\", etc.\n\nThe answer is: "
    ),
    "lcc": "Please complete the code given below. \n{context}Next line of code:\n",
    "repobench-p": (
        "Please complete the code given below. \n{context}{input}Next "
        "line of code:\n"
    ),
}

INFINI_BENCH_TEMPLATE = {
    "passkey": (
        "There is an important info hidden inside a lot of irrelevant "
        "text. Find it and memorize it. I will quiz you about the "
        "important information.\n\n{context}\n\n{input}\n\nThe pass key is"
    ),
    "number_string": (
        "There is an important info hidden inside a lot of irrelevant "
        "text. Find it. I will quiz you about the important information "
        "there.\n\n{context}\n\n{input}\n\nThe sequence of digits is"
    ),
    "kv_retrieval": (
        "Extract the value corresponding to the specified key in the "
        "JSON object below. A specified key value pair is hidden within "
        "the following text. Make sure to memorize it. I will quiz you "
        "about the key value pair afterwards.\n\n{context}\n\nWhat is "
        "the specified value for '{input}' mentioned in the provided "
        "JSON? Please do not reply with the key, but with the value "
        "corresponding to the key.The value associated with '{input}' is:"
    ),
    "longbook_qa_eng": (
        "Read the book and answer the question. Be very concise in "
        "your answer.\n\n{context}\n\nQuestion: {question}\nAnswer:"
    ),
    "longbook_choice_eng": (
        "Read the book and answer the question.\n\n{context}\n\n"
        "Question: {question}\nA. {OPTION_A}\nB. {OPTION_B}\n"
        "C. {OPTION_C}\nD. {OPTION_D}\n\nThe letter of the correct "
        "answer is"
    ),
    "longdialogue_qa_eng": (
        "Below is a dialogue script where one random occurrence of a "
        "character name is replaced with \"$$MASK$$\", and you should "
        "try to guess who that character is.\n\n{context}\n\n{input} "
        "Just give the name without other words. Do not give me random "
        "numbers or something else. The name that has been replaced "
        "with \"$$MASK$$\" is "
    ),
    "code_run": (
        "There is a function called {func} in the following Python "
        "code.\n\n{context}\n\nPlease compute the exact value of "
        "{func_call}. The value of {func_call} is"
    ),
    "math_find": "{prefix}\n\n{context}\n\n{input}",
}


def infini_bench_prompt(example: dict, task: str) -> str:
    """Assemble an InfiniteBench prompt (reference
    data/utils.py:195-285 ``infini_bench_create_prompt``)."""
    template = INFINI_BENCH_TEMPLATE[task]
    eg = dict(example)
    if "content" in eg:
        eg["context"] = eg.pop("content")
    if task == "code_run":
        call = re.findall(r"func_[0-9]+\(\-?[0-9]+\)", eg["input"])[0]
        return template.format(
            func=call.split("(")[0], func_call=call, context=eg["context"]
        )
    if task == "longbook_choice_eng":
        return template.format(
            question=eg["input"], context=eg["context"],
            OPTION_A=eg["options"][0], OPTION_B=eg["options"][1],
            OPTION_C=eg["options"][2], OPTION_D=eg["options"][3],
        )
    if task == "longbook_qa_eng":
        return template.format(question=eg["input"], context=eg["context"])
    if task == "math_find":
        target = re.findall(r"The .+ of", eg["input"])[0].lower()[:-3]
        return template.format(
            prefix=f"What is {target} in the following list?",
            context=eg["context"], input=eg["input"],
        )
    if task == "kv_retrieval":
        eg["input"] = eg["input"].split('"')[1]
    return template.format(context=eg["context"], input=eg["input"])


def load_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]
