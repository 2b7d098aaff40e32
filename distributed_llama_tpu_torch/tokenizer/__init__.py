from .bpe import Tokenizer  # noqa: F401
from .chat import ChatItem, ChatTemplate, TemplateType  # noqa: F401
from .eos import EosDetector, EosResult  # noqa: F401
