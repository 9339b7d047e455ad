"""``mx.gluon.contrib`` of the port: ``nn.MoEDense`` so far.

Counterpart of ``mxnet_tpu/gluon/contrib/``. Its ``estimator``, ``rnn``
and ``data`` modules and the other ``nn`` layers are ROADMAP A13 (d):
asking for one raises ``MXNetError`` naming it.
"""

from ...base import MXNetError
from . import nn  # noqa: F401

_WAITING = ("estimator", "rnn", "data")


def __getattr__(name):
    if name in _WAITING:
        raise MXNetError(f"gluon.contrib.{name} is not ported yet "
                         "(ROADMAP A13 (d))")
    raise AttributeError(name)
