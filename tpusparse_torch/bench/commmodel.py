"""Analytic link-traffic and weak-scaling model of the port's sharded
calls on H100 cards joined by NVLink.

Counterpart of ``tpusparse/bench/commmodel.py``, which models GSPMD on TPU
ICI. This model describes the port's own code (``parallel.sparse``,
``parallel.partition``, ``autodiff.trainable_linear_sharded``): one process
a rank, and every sharded call returns the full y on every rank, so each
partition ends with a gather that GSPMD did not need. For each partition it
lists the collectives a call makes, in order (``comm``'s names), and the
bytes each rank receives over its links; ``CollectiveLog`` records the
same two things from a live call, and the tests hold one to the other at
world size 4.

Per rank, for a slab of (m, n) fp32 (or ``format_bytes`` of a packed
format) and B vectors, D ranks, weak scaling (the slab is fixed):

- ``n``  (output columns shard): K1 on the slab, then ``all_gather_x`` of
  the (B, n) slab of y: (D - 1) * B * n * 4 bytes received.
- ``m``  (contraction rows shard): the partial y is full width n and
  ``psum_y`` sums it: a ring all-reduce, 2 (D - 1) / D * B * n * 4 bytes.
- ``ring`` (both): D - 1 ``ring_shift``s of the (B, m) x chunk, each
  overlapping one band's compute (compute / D), then the gather of y.
- ``halo`` (DIA): ``ring_shift``s of the x edges (``halo``: the left and
  the right neighbour's) and, for a symmetric operator, of the vals edge
  (``vals_halo`` elements), then the local product and the gather of y.
- ``train`` (one training step): the forward's gather of y, then
  ``psum_y`` of the (B, m) dx; both value gradients are local. Its compute
  is 4 passes over the slab (forward, dx, dvals, dvals_t).

Times: compute = ``lowering`` x slab bytes / HBM rate; link time = bytes /
the per-direction NVLink rate. The collectives follow the kernels (only the
ring overlaps its shifts), and the model charges no latency: it bounds the
efficiency from above. ``lowering`` is the port's measured ratio of a
sharded call at world size 1 to the unsharded call (``LOWERING``).
"""

from __future__ import annotations

import contextlib
import dataclasses

# The H100 SXM's published figures (NVIDIA H100 Tensor Core GPU datasheet):
# HBM3 at 3.35 TB/s; fourth-generation NVLink at 900 GB/s a GPU in all
# (18 links), 450 GB/s each way, which a ring over NVSwitch can use.
HBM_GBPS = 3350.0
NVLINK_GBPS = 450.0
# The port's own world-size-1 overheads (the sharded call over the unsharded
# one, ``bench.shard_overhead`` on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md
# section 5): SELL, DIA through the halo partition, TCSR.
LOWERING = {"sell": 1.009, "dia_halo": 1.700, "tcsr": 1.041}

_KINDS = ("all_gather_x", "psum_y", "reduce_scatter_y", "ring_shift")


@dataclasses.dataclass
class CommEstimate:
    partition: str
    compute_s: float                # per-call local compute time (HBM bound)
    link_bytes: int                 # bytes a rank receives in one call
    comm_s: float                   # link time of those bytes
    call_s: float                   # modelled time of one call
    efficiency: float               # weak-scaling efficiency against 1 rank
    collectives: tuple[str, ...]    # comm's calls, in order

    def __str__(self) -> str:
        return (f"[{self.partition}] compute {self.compute_s * 1e6:.1f} us"
                f" + links {self.link_bytes / 1e6:.3f} MB"
                f" -> {self.call_s * 1e6:.1f} us/call,"
                f" weak efficiency {self.efficiency * 100:.1f}%")


def received_bytes(kind: str, nbytes: int, d: int) -> int:
    """Bytes one rank receives in ``comm.<kind>`` of an ``nbytes`` input
    over ``d`` ranks (ring algorithms; nothing at d = 1)."""
    if d == 1:
        return 0
    if kind == "all_gather_x":
        return (d - 1) * nbytes
    if kind == "psum_y":
        return int(2 * (d - 1) * nbytes / d)
    if kind == "reduce_scatter_y":
        return int((d - 1) * nbytes / d)
    if kind == "ring_shift":
        return nbytes
    raise ValueError(f"unknown collective {kind!r}")


def _estimate(partition, compute, steps, d, overlap_ring=False,
              nvlink_gbps=NVLINK_GBPS) -> CommEstimate:
    link = sum(received_bytes(k, b, d) for k, b in steps)
    comm = link / (nvlink_gbps * 1e9)
    if overlap_ring:
        shifts = [received_bytes(k, b, d) for k, b in steps
                  if k == "ring_shift"]
        step = max([compute / d] + [s / (nvlink_gbps * 1e9) for s in shifts])
        rest = (link - sum(shifts)) / (nvlink_gbps * 1e9)
        call = len(shifts) * step + compute / d + rest
    else:
        call = compute + comm
    return CommEstimate(partition=partition, compute_s=compute,
                        link_bytes=link, comm_s=comm, call_s=call,
                        efficiency=compute / call if call else 1.0,
                        collectives=tuple(k for k, _ in steps))


def comm_model(partition: str, *, m: int, n: int, batch: int = 1,
               n_devices: int = 8, format_bytes: int | None = None,
               halo: tuple[int, int] = (0, 0), vals_halo: int = 0,
               lowering: float = 1.0,
               hbm_gbps: float = HBM_GBPS,
               nvlink_gbps: float = NVLINK_GBPS) -> CommEstimate:
    """One sharded call on a rank's (m, n) slab: ``m`` is the x length the
    rank reads (its chunk for ``m`` and ``ring``), ``n`` the output columns
    it computes (all of them for ``m``). ``halo`` (the x edges from the
    left and the right neighbour) and ``vals_halo`` (the vals edge), in
    elements, size the halo partition's shifts; an edge of 0 is not
    shifted."""
    slab = format_bytes if format_bytes is not None else m * n * 4
    compute = lowering * slab / (hbm_gbps * 1e9)
    d = n_devices
    y = batch * n * 4
    gather = ("all_gather_x", y)
    if partition == "n":
        steps = [gather]
    elif partition == "m":
        steps = [("psum_y", y)]
    elif partition == "ring":
        steps = [("ring_shift", batch * m * 4)] * (d - 1) + [gather]
    elif partition == "halo":
        steps = [("ring_shift", batch * e * 4) for e in halo if e]
        steps += [("ring_shift", vals_halo * 4)] * bool(vals_halo)
        steps.append(gather)
    else:
        raise ValueError(f"unknown partition {partition!r}")
    return _estimate(partition, compute, steps, d,
                     overlap_ring=partition == "ring",
                     nvlink_gbps=nvlink_gbps)


def train_model(*, m: int, n: int, batch: int = 1, n_devices: int = 8,
                format_bytes: int | None = None, hbm_gbps: float = HBM_GBPS,
                nvlink_gbps: float = NVLINK_GBPS) -> CommEstimate:
    """One step of ``trainable_linear_sharded`` on a rank's slab: its n
    output columns of an (m, .) weight, the full (B, m) x."""
    slab = format_bytes if format_bytes is not None else m * n * 4
    compute = 4 * slab / (hbm_gbps * 1e9)
    steps = [("all_gather_x", batch * n * 4), ("psum_y", batch * m * 4)]
    return _estimate("train", compute, steps, n_devices,
                     nvlink_gbps=nvlink_gbps)


class CollectiveLog:
    """Records every collective of ``parallel.comm`` made inside the
    ``with`` block, on this rank: ``calls`` is a list of (kind, bytes
    received), by ``received_bytes`` from the input's size and the group's.
    The wrappers call the real collectives; nothing else changes."""

    def __init__(self):
        self.calls: list[tuple[str, int]] = []

    @property
    def kinds(self) -> tuple[str, ...]:
        return tuple(k for k, _ in self.calls)

    @property
    def link_bytes(self) -> int:
        return sum(b for _, b in self.calls)

    @contextlib.contextmanager
    def recording(self):
        from tpusparse_torch.parallel import comm

        real = {k: getattr(comm, k) for k in _KINDS}

        def wrap(kind):
            def call(t, group, *args, **kw):
                nbytes = t.numel() * t.element_size()
                self.calls.append(
                    (kind, received_bytes(kind, nbytes, group.size())))
                return real[kind](t, group, *args, **kw)
            return call

        for k in _KINDS:
            setattr(comm, k, wrap(k))
        try:
            yield self
        finally:
            for k, f in real.items():
                setattr(comm, k, f)


def report(m: int = 4096, n: int = 4096, batch: int = 1,
           device_counts: tuple[int, ...] = (2, 4, 8),
           format_bytes: int | None = None,
           card: str | None = None) -> str:
    """The model on a headline-sized slab at each D; ``card`` is the line
    ``nvidia-smi`` gives for the card whose figures stand here (read when
    omitted, "not measured" without one)."""
    if card is None:
        try:
            from tpusparse_torch.bench.roofline import card_info

            card = card_info()["line"]
        except Exception:             # no nvidia-smi: no card to name
            card = "not measured"
    fb = '' if format_bytes is None else \
        f' ({format_bytes / 1e6:.1f} MB packed)'
    lines = [f"comm model: per-rank slab {m}x{n} fp32{fb}, B={batch}; H100 "
             f"SXM published HBM3 {HBM_GBPS:.0f} GB/s, NVLink 4 "
             f"{NVLINK_GBPS:.0f} GB/s each way; card: {card}"]
    for d in device_counts:
        for p in ("n", "m", "ring"):
            e = comm_model(p, m=m, n=n, batch=batch, n_devices=d,
                           format_bytes=format_bytes,
                           lowering=LOWERING["sell"])
            lines.append(f"D={d:3d} {e}")
        # the 1M Laplacian's K8 strips (offsets 0, 1, 1024, symmetric):
        # 2048 x elements each way and the 3 x 2048 vals strip
        eh = comm_model("halo", m=m, n=n, batch=batch, n_devices=d,
                        format_bytes=format_bytes, halo=(2048, 2048),
                        vals_halo=3 * 2048, lowering=LOWERING["dia_halo"])
        lines.append(f"D={d:3d} {eh}")
        t = train_model(m=m, n=n, batch=batch, n_devices=d,
                        format_bytes=format_bytes)
        lines.append(f"D={d:3d} {t}")
    return "\n".join(lines)


if __name__ == "__main__":
    print(report())
