"""Models of the port."""

from . import bert  # noqa: F401
from . import llama  # noqa: F401
from . import transformer  # noqa: F401
from .bert import bert_base, bert_large, get_bert_model  # noqa: F401
from .llama import (  # noqa: F401
    LlamaModel,
    get_llama,
    llama3_8b,
    llama_tiny,
)
from .transformer import (  # noqa: F401
    Transformer,
    TransformerDecoderCell,
)
