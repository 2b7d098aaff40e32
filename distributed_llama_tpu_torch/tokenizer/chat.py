"""Chat template engine — the reference's four hardcoded templates with substring
auto-detection of the tokenizer's embedded Jinja template (src/tokenizer.cpp:436-500)."""

from __future__ import annotations

import enum
from dataclasses import dataclass


class TemplateType(enum.Enum):
    UNKNOWN = "unknown"
    LLAMA2 = "llama2"
    LLAMA3 = "llama3"
    ZEPHYR = "zephyr"
    CHATML = "chatml"


@dataclass
class ChatItem:
    role: str
    message: str


class ChatTemplate:
    def __init__(self, ttype: TemplateType | str, chat_template: str | None,
                 eos: str):
        if isinstance(ttype, str):
            ttype = TemplateType(ttype)
        if ttype == TemplateType.UNKNOWN:
            if chat_template is None:
                raise ValueError("the tokenizer does not include a chat template")
            if "[INST]" in chat_template:
                ttype = TemplateType.LLAMA2
            elif "<|start_header_id|>" in chat_template:
                ttype = TemplateType.LLAMA3
            elif "<|user|>" in chat_template:
                ttype = TemplateType.ZEPHYR
            elif "<|im_start|>" in chat_template:
                ttype = TemplateType.CHATML
            else:
                raise ValueError("unsupported chat template")
        self.type = ttype
        self.eos = eos

    def generate(self, items: list[ChatItem], append_generation_prompt: bool = True) -> str:
        """Reference ChatTemplate::generate (tokenizer.cpp:468-500), verbatim behavior."""
        eos = self.eos
        out: list[str] = []
        if self.type == TemplateType.LLAMA2:
            i = 0
            if len(items) >= 2 and items[0].role == "system" and items[1].role == "user":
                out.append(f"[INST] <<SYS>>\n{items[0].message}\n<</SYS>>\n\n"
                           f"{items[1].message} [/INST]{eos}")
                i = 2
            for item in items[i:]:
                if item.role == "assistant":
                    out.append(f"{item.message}{eos}")
                elif item.role == "user":
                    out.append(f"[INST] {item.message} [/INST]{eos}")
        elif self.type == TemplateType.LLAMA3:
            for item in items:
                out.append(f"<|start_header_id|>{item.role}<|end_header_id|>\n\n"
                           f"{item.message}{eos}")
            if append_generation_prompt:
                out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
        elif self.type == TemplateType.CHATML:
            for item in items:
                out.append(f"<|im_start|>{item.role}\n{item.message}<|im_end|>\n")
            if append_generation_prompt:
                out.append("<|im_start|>assistant\n")
        elif self.type == TemplateType.ZEPHYR:
            for item in items:
                out.append(f"<|{item.role}|>\n{item.message}{eos}\n")
            if append_generation_prompt:
                out.append("<|assistant|>\n")
        return "".join(out)
