"""Models of the port."""

from . import bert  # noqa: F401
from .bert import bert_base, bert_large, get_bert_model  # noqa: F401
