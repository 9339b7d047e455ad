"""What the zoo's families share."""

from ....base import MXNetError


def refuse_pretrained(pretrained):
    """Pretrained files are not shipped: ``pretrained=True`` raises, as in
    the JAX package."""
    if pretrained:
        raise MXNetError(
            "pretrained weights are not shipped; carry weights in with "
            "gluon.utils.load_numpy or load_parameters")
