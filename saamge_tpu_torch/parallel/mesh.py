"""A one-dimensional mesh of shards driven by one process, the port's
counterpart of the ``jax.sharding.Mesh`` that saamge_tpu/parallel/
structured_sharded.py maps over, with the three collectives it uses.

A ``ShardMesh`` is a list of ``torch.device``s, one per shard; a device
may repeat (``[cuda:0] * 4`` puts four shards on one card, ``[cpu] * 4``
runs them on the CPU).  A sharded value is a ``ShardTensor``: one tensor
per shard, each on its shard's device.  Exchanges move data with
``.to(dst)``, between distinct cards a peer copy: four shards on four
cards give four shards of one card's results bit for bit
(``chip_smoke.py --cards 4``).

Collectives (the JAX file's ``ppermute``, ``all_gather`` and ``psum``):

  ppermute_right / ppermute_left  each shard's part to its right / left
                                  neighbour, zeros at the chain's end
  all_gather                      the parts stacked along a new axis,
                                  once per distinct device
  psum                            the parts summed in shard order, once
                                  per distinct device, so every shard
                                  holds the same bits

A collective's result may share memory with its inputs (``.to`` of a
tensor already on its device is the tensor itself), and the shards of
one device share one gathered or summed tensor: read them, do not write
into them."""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def _part(obj, i: int):
    """``obj`` with every ShardTensor in it replaced by its i-th part."""
    if isinstance(obj, ShardTensor):
        return obj.parts[i]
    if isinstance(obj, (list, tuple)):
        return type(obj)(_part(o, i) for o in obj)
    return obj


def _shards(args, kwargs) -> int:
    for obj in (*args, *kwargs.values()):
        if isinstance(obj, ShardTensor):
            return len(obj.parts)
        if isinstance(obj, (list, tuple)):
            n = _shards(obj, {})
            if n:
                return n
    return 0


def _each(fn: Callable, args, kwargs):
    """fn applied shard by shard; tensors come back as a ShardTensor."""
    out = [fn(*_part(args, i), **{k: _part(v, i) for k, v in kwargs.items()})
           for i in range(_shards(args, kwargs))]
    if all(o is None for o in out):
        return None
    if all(isinstance(o, torch.Tensor) for o in out):
        return ShardTensor(out)
    return out


class ShardTensor:
    """One tensor per shard.  Torch functions (``torch.add(..., out=)``,
    ``torch.zeros_like``), tensor methods (``add_``, ``copy_``,
    ``clone``) and arithmetic apply shard by shard, so code written for
    one tensor (the PCG loop of solve/device_pcg.py) runs unchanged on a
    sharded vector.  ``dtype``, ``device`` and ``shape`` are the first
    shard's; ``lead`` is its tensor."""

    __slots__ = ("parts",)

    def __init__(self, parts: Sequence[torch.Tensor]):
        self.parts = tuple(parts)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return _each(func, args, kwargs or {})

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return lambda *a, **kw: _each(
            lambda t, *a, **kw: getattr(t, name)(*a, **kw), (self,) + a, kw)

    def __getitem__(self, i: int) -> torch.Tensor:
        return self.parts[i]

    def __iter__(self):
        return iter(self.parts)

    @property
    def lead(self) -> torch.Tensor:
        return self.parts[0]

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self):
        return self.parts[0].device

    @property
    def shape(self):
        return self.parts[0].shape

    def __add__(self, o):
        return _each(torch.Tensor.__add__, (self, o), {})

    def __sub__(self, o):
        return _each(torch.Tensor.__sub__, (self, o), {})

    def __mul__(self, o):
        return _each(torch.Tensor.__mul__, (self, o), {})

    def __rmul__(self, o):
        return _each(torch.Tensor.__rmul__, (self, o), {})

    def __truediv__(self, o):
        return _each(torch.Tensor.__truediv__, (self, o), {})


def _index(dev: torch.device) -> torch.device:
    """``cuda`` without an index is the current card."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class ShardMesh:
    """Shards on ``devices`` (one entry per shard, repeats allowed), in
    chain order: shard d's neighbours are d - 1 and d + 1."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(_index(torch.device(d)) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        # the distinct devices in first-use order, and the first shard of each
        self.unique = tuple(dict.fromkeys(self.devices))
        self._first = {dev: self.devices.index(dev) for dev in self.unique}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def one_device(self) -> bool:
        return len(self.unique) == 1

    def put(self, parts: Sequence[torch.Tensor]) -> ShardTensor:
        """Part d on shard d's device."""
        if len(parts) != self.size:
            raise ValueError(f"{len(parts)} parts for {self.size} shards")
        return ShardTensor([p.to(dev) for p, dev in zip(parts, self.devices)])

    def replicate(self, t: torch.Tensor) -> ShardTensor:
        """``t`` on every shard: one copy a distinct device."""
        copies = {dev: t.to(dev) for dev in self.unique}
        return ShardTensor([copies[dev] for dev in self.devices])

    def ppermute_right(self, parts) -> ShardTensor:
        """Shard d receives shard d - 1's part; shard 0 receives zeros."""
        return ShardTensor(
            [torch.zeros_like(parts[0])]
            + [parts[d - 1].to(self.devices[d]) for d in range(1, self.size)])

    def ppermute_left(self, parts) -> ShardTensor:
        """Shard d receives shard d + 1's part; the last shard zeros."""
        last = self.size - 1
        return ShardTensor(
            [parts[d + 1].to(self.devices[d]) for d in range(last)]
            + [torch.zeros_like(parts[last])])

    def per_device(self, fn: Callable, parts) -> ShardTensor:
        """fn(part) computed once per distinct device, on the part of the
        device's first shard, and shared by the device's shards: for a
        replicated computation, whose inputs agree on every shard."""
        out = {dev: fn(parts[self._first[dev]]) for dev in self.unique}
        return ShardTensor([out[dev] for dev in self.devices])

    def all_gather(self, parts, dim: int = 0) -> ShardTensor:
        """The parts stacked along a new axis ``dim``, in shard order."""
        return self.per_device(lambda p: torch.stack(
            [q.to(p.device) for q in parts], dim), parts)

    def psum(self, parts) -> ShardTensor:
        """The sum of the parts, added left to right in shard order on
        every device, so every shard holds the same bits."""
        def total(p):
            acc = parts[0].to(p.device)
            for q in parts[1:]:
                acc = acc + q.to(p.device)
            return acc
        return self.per_device(total, parts)
