"""Random number generation: ``mx.random`` and ``mx.nd.random``.

PyTorch counterpart of ``mxnet_tpu/random.py`` (reference:
``src/operator/random/`` with ``ResourceRequest::kRandom``, stateful
per-device generators seeded by ``mx.random.seed``). Each device has one
stream, its ``torch.Generator``: the CPU's default generator, and each
card's default CUDA generator. Every random draw of the port names the
generator of its device explicitly (:func:`generator`): the samplers
below, the ``Dropout`` operator (so dropout in a hybridized block's CUDA
graph too: a capture registers the card's generator, and every replay
draws the next numbers of the stream, from its seed as it stands when the
replay runs) and ``SPMDTrainStep``'s dropout; SGLD's noise has a
generator of its own that each :func:`seed` seeds again.

:func:`seed` seeds the generators, so a run repeats bit for bit from the
same seed; seeding after a capture needs no new capture. The streams are
torch's Philox, not the JAX package's threefry: the two packages draw
different numbers from one seed, with the same distributions.
"""

from __future__ import annotations

import math

import torch

from .context import Context, current_context, resolve_device


def generator(device) -> torch.Generator:
    """The stream of ``device`` (a ``torch.device``, a Context or a
    string): the card's default CUDA generator, or the CPU's."""
    if not isinstance(device, torch.device):
        device = resolve_device(device)
    if device.type == "cuda":
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        return torch.cuda.default_generators[index]
    return torch.default_generator


_EPOCH = [0]


def seed_epoch() -> int:
    """How many times :func:`seed` ran: a generator of its own (SGLD's)
    seeds itself again when this moves."""
    return _EPOCH[0]


def seed(seed_state, ctx="all"):
    """Seed the stream of ``ctx``, or of every device (``"all"``: the CPU
    and every card)."""
    s = int(seed_state)
    _EPOCH[0] += 1
    if isinstance(ctx, str) and ctx == "all":
        torch.manual_seed(s)  # the CPU, and every card (lazily before use)
        return
    generator(Context(ctx)).manual_seed(s)


def _device(ctx):
    return resolve_device(Context(ctx) if ctx is not None
                          else current_context())


def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


def _dtype(dtype):
    from .ndarray.ndarray import torch_dtype

    return torch_dtype(dtype)


def _out(t, out):
    from .ndarray.ndarray import NDArray

    if out is not None:
        out._set_data(t)
        return out
    return NDArray(t)


def _params(ctx, out, *params):
    """The device of the draw and each parameter as a number or a tensor
    there: an NDArray parameter is unwrapped (its device is the draw's
    when neither ``ctx`` nor ``out`` names one)."""
    from .ndarray.ndarray import NDArray

    if out is not None:
        dev = out.data.device
    elif ctx is None and any(isinstance(p, NDArray) for p in params):
        dev = next(p for p in params if isinstance(p, NDArray)).data.device
    else:
        dev = _device(ctx)
    vals = [p.data.detach().to(dev) if isinstance(p, NDArray) else
            float(p) for p in params]
    return (dev, *vals)


def _draw(out, dtype, shape):
    """The type and shape of a draw: ``out``'s, or ``dtype``/``shape``."""
    if out is not None:
        return out.data.dtype, out.shape
    return _dtype(dtype), _shape(shape)


def _full(shp, value, dev):
    """``value`` (a number or a tensor) broadcast over ``shp`` and its own
    shape, as a float32 tensor of parameters, one per draw."""
    v = torch.as_tensor(value, dtype=torch.float32, device=dev)
    return v.expand(torch.broadcast_shapes(shp, v.shape)).contiguous()


# The location-scale samplers draw ONE z of ``shape`` (default ``()``)
# and broadcast it over NDArray parameters, as the JAX package's
# ``loc + scale * z`` does (mxnet_tpu/random.py:83-88, :113-118); MXNet
# 1.x drew one value per parameter element (ROADMAP C17). The samplers
# whose parameter shapes the distribution (gamma, poisson, bernoulli,
# randint) draw one value per element of the broadcast parameters.

def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
            out=None, **kw):
    """Uniform on ``[low, high)``."""
    dev, low, high = _params(ctx, out, low, high)
    dt, shp = _draw(out, dtype, shape)
    u = torch.rand(shp, generator=generator(dev), device=dev, dtype=dt)
    return _out(u * (high - low) + low, out)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
           out=None, **kw):
    dev, loc, scale = _params(ctx, out, loc, scale)
    dt, shp = _draw(out, dtype, shape)
    z = torch.randn(shp, generator=generator(dev), device=dev, dtype=dt)
    return _out(loc + scale * z, out)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None, **kw):
    return normal(loc, scale, shape, dtype=dtype, ctx=ctx)


def randint(low, high=None, shape=None, dtype="int32", ctx=None, out=None,
            **kw):
    """Integers in ``[low, high)`` (``[0, low)`` with one bound)."""
    if high is None:
        low, high = 0, low
    dev, low, high = _params(ctx, out, low, high)
    dt, shp = _draw(out, dtype, shape)
    if isinstance(low, float) and isinstance(high, float):
        r = torch.randint(int(low), int(high), shp, generator=generator(dev),
                          device=dev, dtype=torch.int64)
    else:
        lo, hi = _full(shp, low, dev), _full(shp, high, dev)
        lo, hi = torch.broadcast_tensors(lo, hi)
        u = torch.rand(lo.shape, generator=generator(dev), device=dev,
                       dtype=torch.float64)
        r = (lo.double() + torch.floor(u * (hi - lo).double())).long()
    return _out(r.to(dt), out)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None,
          out=None, **kw):
    """Gamma with shape ``alpha`` and scale ``beta`` (mean alpha*beta).
    torch's gamma sampler takes no generator argument: it draws from the
    device's default generator, which is this module's stream."""
    dev, alpha, beta = _params(ctx, out, alpha, beta)
    dt, shp = _draw(out, dtype, shape)
    a = _full(shp, alpha, dev)
    return _out((torch._standard_gamma(a) * beta).to(dt), out)


def exponential(scale=1.0, shape=None, dtype="float32", ctx=None, out=None,
                **kw):
    dev, scale = _params(ctx, out, scale)
    dt, shp = _draw(out, dtype, shape)
    e = torch.empty(shp, device=dev, dtype=torch.float32).exponential_(
        1.0, generator=generator(dev))
    return _out((e * scale).to(dt), out)


def poisson(lam=1.0, shape=None, dtype="float32", ctx=None, out=None, **kw):
    dev, lam = _params(ctx, out, lam)
    dt, shp = _draw(out, dtype, shape)
    rates = _full(shp, lam, dev)
    return _out(torch.poisson(rates, generator=generator(dev)).to(dt), out)


def bernoulli(prob=0.5, shape=None, dtype="float32", ctx=None, **kw):
    dev, prob = _params(ctx, None, prob)
    p = _full(_shape(shape), prob, dev)
    return _out(torch.bernoulli(p, generator=generator(dev))
                .to(_dtype(dtype)), None)


def multinomial(data, shape=1, get_prob=False, dtype="int32", **kw):
    """``shape`` draws from each distribution (a row of ``data``, a
    probability vector or a batch of them); with ``get_prob`` also each
    draw's log-probability."""
    from .ndarray.ndarray import NDArray

    p = data.data if isinstance(data, NDArray) else torch.as_tensor(data)
    n = shape if isinstance(shape, int) else int(math.prod(shape))
    probs = p.detach().float().clamp_min(0)
    flat = probs.reshape(-1, probs.shape[-1])
    s = torch.multinomial(flat, n, replacement=True,
                          generator=generator(p.device))
    if p.dim() == 1:
        s = s.reshape(n)
    elif n == 1:
        s = s[:, 0]
    out = NDArray(s.to(_dtype(dtype)))
    if get_prob:
        logp = torch.log_softmax(torch.log(flat.clamp_min(1e-38)), dim=-1)
        lp = torch.gather(logp, 1, s.reshape(flat.shape[0], -1)) \
            .reshape(s.shape)
        return out, NDArray(lp)
    return out


def shuffle(data, **kw):
    """The rows of ``data`` (axis 0) in a random order (a new array)."""
    from .ndarray.ndarray import NDArray

    t = data.data
    perm = torch.randperm(t.shape[0], generator=generator(t.device),
                          device=t.device)
    return NDArray(t.detach().index_select(0, perm))


# the reference's older names
sample_uniform = uniform
sample_normal = normal
sample_gamma = gamma
sample_exponential = exponential
sample_poisson = poisson
