"""Per-model-family prompt templates.

Parity with the reference template tables
(reference models/prompt_template.py:20-45): ``CTX_TEMPLATES`` wraps a
long context as the first user turn, ``CHAT_TEMPLATES`` wraps follow-up
queries against a prefilled context, ``PREFIX_TEMPLATES`` closes the
first turn with a stock assistant acknowledgement so continued chat
turns can be appended.
"""

from __future__ import annotations

_SYSTEM = "You are a helpful assistant"

CTX_TEMPLATES = {
    "base": "{ctx}",
    "llama-3": (
        "<|start_header_id|>system<|end_header_id|>" + _SYSTEM
        + "<|eot_id|><|start_header_id|>user<|end_header_id|>{ctx}"
        + "<|eot_id|><|start_header_id|>assistant<|end_header_id|>"
    ),
    "yi": (
        "<|im_start|>system\n" + _SYSTEM + "<|im_end|>\n"
        "<|im_start|>user\n{ctx}<|im_end|>\n<|im_start|>assistant\n"
    ),
    "glm": "<|system|>\n" + _SYSTEM + "\n<|user|> \n{ctx}<|assistant|>\n",
    "qwen": (
        "<|im_start|>system\n" + _SYSTEM + "<|im_end|>\n"
        "<|im_start|>user\n{ctx}<|im_end|>\n<|im_start|>assistant\n"
    ),
    "phi": "<|system|>\n" + _SYSTEM + "<|end|>\n<|user|>\n{ctx}<|end|>\n<|assistant|>\n",
}

CHAT_TEMPLATES = {
    "base": "{msg}",
    "llama-3": (
        "<|start_header_id|>user<|end_header_id|>{msg}<|eot_id|>"
        "<|start_header_id|>assistant<|end_header_id|>"
    ),
    "yi": "<|im_start|>user\n{msg}<|im_end|>\n<|im_start|>assistant\n",
    "glm": "<|user|>\n{msg}<|assistant|>\n",
    "qwen": "<|im_start|>user\n{msg}<|im_end|>\n<|im_start|>assistant\n",
    "phi": "<|user|>\n{msg}<|end|>\n<|assistant|>\n",
}

_ACK = "OK! I will help you with that. Please ask me anything."

PREFIX_TEMPLATES = {
    "base": "{ctx}",
    "llama-3": (
        CTX_TEMPLATES["llama-3"] + _ACK + "<|eot_id|>"
    ),
    "yi": CTX_TEMPLATES["yi"] + _ACK + "\n",
    "glm": CTX_TEMPLATES["glm"] + _ACK + "\n",
}


def template_family(model_name: str) -> str:
    """Model-name substring -> template family (reference
    data/dataset.py:133-146 uses the same substring dispatch)."""
    lower = model_name.lower()
    for key in ("llama-3", "yi", "glm", "qwen", "phi"):
        if key in lower:
            return key
    return "base"


# Stop tokens per family, as token *strings*; resolved to ids via the
# tokenizer at engine setup (reference models/base.py:385-497 maintains
# the equivalent stop-token zoo inline in generate()).
STOP_STRINGS = {
    "base": ["</s>"],
    "llama-3": ["<|eot_id|>", "<|end_of_text|>"],
    "yi": ["<|im_end|>", "<|endoftext|>"],
    "glm": ["<|user|>", "<|endoftext|>", "<|observation|>"],
    "qwen": ["<|im_end|>", "<|endoftext|>"],
    "phi": ["<|end|>", "<|endoftext|>"],
}
