# Copy of dmi_tpu/chat_templates.py with its dmi_tpu imports rewritten to dmi_tpu_torch, so that
# the port loads no module of the JAX package (tests/test_torch_isolation.py holds the two equal).
"""Llama-3.x chat templates with ``{% generation %}`` assistant spans.

The reference installs custom Llama 3.1/3.2 Jinja chat templates whose only
functional difference from stock Meta templates is wrapping the assistant
content in ``{% generation %} ... {% endgeneration %}`` so that
``apply_chat_template(..., return_assistant_tokens_mask=True)`` yields the
label mask used for loss masking (reference: dmi/model/__init__.py:134-357,
consumed at dmi/data/base.py:23-31).

We implement a compact clean-room template covering the conversation shapes
this framework actually uses (system? + alternating user/assistant, no tool
calls).  Rendered output is byte-identical to the reference template for
those shapes:

    <|begin_of_text|><|start_header_id|>system<|end_header_id|>\n\n
    Cutting Knowledge Date: December 2023\nToday Date: {date}\n\n{system}<|eot_id|>
    then per message:
    <|start_header_id|>{role}<|end_header_id|>\n\n{content|trim}<|eot_id|>
    with assistant turns rendered as header + '\n\n' + '\n' (unmasked) +
    generation-span(content|trim + <|eot_id|> + '\n'), and an optional
    trailing assistant header when add_generation_prompt=True.  The two
    extra newlines replicate what the reference template's indentation
    emits under HF's jinja env (see the inline comment below).

Llama 3.1 uses the fixed date "26 Jul 2024"; Llama 3.2 uses today's date via
``strftime_now`` when the runtime provides it (HF does).
"""

from __future__ import annotations

_COMMON = (
    "{{- bos_token }}"
    "{%- if messages[0]['role'] == 'system' %}"
    "{%- set system_message = messages[0]['content'] | trim %}"
    "{%- set messages = messages[1:] %}"
    "{%- else %}"
    "{%- set system_message = '' %}"
    "{%- endif %}"
    "{{- '<|start_header_id|>system<|end_header_id|>\\n\\n' }}"
    "{{- 'Cutting Knowledge Date: December 2023\\n' }}"
    "{{- 'Today Date: ' + date_string + '\\n\\n' }}"
    "{{- system_message }}"
    "{{- '<|eot_id|>' }}"
    "{%- for message in messages %}"
    "{%- if message['role'] != 'assistant' %}"
    "{{- '<|start_header_id|>' + message['role'] + '<|end_header_id|>\\n\\n' + message['content'] | trim + '<|eot_id|>' }}"
    "{%- else %}"
    # The reference template's sloppy indentation around its generation tags
    # renders (under HF's trim_blocks/lstrip_blocks jinja env) an extra
    # UNMASKED '\n' between the assistant header and the content, and a
    # MASKED '\n' after <|eot_id|> inside the generation span.  Both are
    # real tokens in the training data and the decoded text — the
    # reference's gts post-processing splits on 'assistant\n\n\n'
    # (dmi/train.py:194), which only matches because of the first one.
    # Emitted explicitly here; byte+mask parity pinned in
    # tests/test_chat_template.py against the executed reference template.
    "{{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}"
    "{{- '\\n' }}"
    "{% generation %}"
    "{{- message['content'] | trim + '<|eot_id|>' + '\\n' }}"
    "{% endgeneration %}"
    "{%- endif %}"
    "{%- endfor %}"
    "{%- if add_generation_prompt %}"
    "{{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}"
    "{%- endif %}"
)

# Llama 3.1: fixed default date (reference: dmi/model/__init__.py:141-143).
LLAMA31_CHAT_TEMPLATE = (
    "{%- if not date_string is defined %}"
    "{%- set date_string = '26 Jul 2024' %}"
    "{%- endif %}" + _COMMON
)

# Llama 3.2: current date via strftime_now (reference: dmi/model/__init__.py:258-264).
LLAMA32_CHAT_TEMPLATE = (
    "{%- if not date_string is defined %}"
    "{%- if strftime_now is defined %}"
    "{%- set date_string = strftime_now('%d %b %Y') %}"
    "{%- else %}"
    "{%- set date_string = '26 Jul 2024' %}"
    "{%- endif %}"
    "{%- endif %}" + _COMMON
)

# LM name -> template (reference: dmi/model/__init__.py:352-357).
LLMS_CHATTEMPLATES = {
    "meta-llama/Llama-3.1-8B-Instruct": LLAMA31_CHAT_TEMPLATE,
    "meta-llama/Llama-3.1-70B-Instruct": LLAMA31_CHAT_TEMPLATE,
    "meta-llama/Llama-3.2-1B-Instruct": LLAMA32_CHAT_TEMPLATE,
    "meta-llama/Llama-3.2-3B-Instruct": LLAMA32_CHAT_TEMPLATE,
}
