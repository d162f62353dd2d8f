"""The Llama-3 chat templates of chat_templates.py rendered in Python, with
the character spans of their `{% generation %}` blocks.

render() gives what transformers' apply_chat_template(..., tokenize=False)
gives for LLAMA31_CHAT_TEMPLATE and LLAMA32_CHAT_TEMPLATE under HF's jinja
environment, and the (start, end) character spans that its assistant tracker
records for return_assistant_tokens_mask.  The date line is `date_string`
when the caller passes one, else "26 Jul 2024" (3.1) or today's
strftime("%d %b %Y") (3.2, as HF's strftime_now).  No other template is
rendered: the port carries no jinja engine.
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Sequence, Tuple

from dmi_tpu_torch.chat_templates import LLAMA31_CHAT_TEMPLATE, LLAMA32_CHAT_TEMPLATE

_HEADER = "<|start_header_id|>{}<|end_header_id|>\n\n"
_EOT = "<|eot_id|>"
_FIXED_DATE = "26 Jul 2024"


def _default_date(template: str) -> str:
    if template == LLAMA31_CHAT_TEMPLATE:
        return _FIXED_DATE
    if template == LLAMA32_CHAT_TEMPLATE:
        return datetime.datetime.now().strftime("%d %b %Y")
    raise NotImplementedError(
        "the port renders LLAMA31_CHAT_TEMPLATE and LLAMA32_CHAT_TEMPLATE of "
        "dmi_tpu_torch.chat_templates only")


def render(template: str, messages: Sequence[Dict[str, str]], bos_token: str,
           add_generation_prompt: bool = False,
           **template_kwargs) -> Tuple[str, List[Tuple[int, int]]]:
    """(rendered chat, generation spans) of one conversation."""
    fallback = _default_date(template)  # refuses a template it cannot render
    date = template_kwargs.get("date_string", fallback)
    messages = list(messages)
    system = ""
    if messages[0]["role"] == "system":
        system = messages[0]["content"].strip()
        messages = messages[1:]
    out = [bos_token, _HEADER.format("system"), "Cutting Knowledge Date: December 2023\n",
           f"Today Date: {date}\n\n", system, _EOT]
    spans = []
    for message in messages:
        if message["role"] != "assistant":
            out.append(_HEADER.format(message["role"]) + message["content"].strip() + _EOT)
        else:
            # the unmasked '\n' after the header, then the generation span
            # (chat_templates._COMMON)
            out.append(_HEADER.format("assistant") + "\n")
            start = sum(map(len, out))
            out.append(message["content"].strip() + _EOT + "\n")
            spans.append((start, start + len(out[-1])))
    if add_generation_prompt:
        out.append(_HEADER.format("assistant"))
    return "".join(out), spans
