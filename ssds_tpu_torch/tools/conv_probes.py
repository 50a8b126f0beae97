"""Run the conv prototype's 19 probes through the port's CUDA kernels.

    python -m ssds_tpu_torch.tools.conv_probes

The counterpart of ``tools/pallas_conv_bisect.py``, ``pallas_conv_bisect2.py``,
``pallas_conv_bisect3.py`` and ``pallas_elem_halo_probe.py``, at their sizes
and with their inputs (``numpy.random.default_rng(0)``). The 17 stencil
probes (``ssds_tpu_torch.ops.stencil.PROBES``) run through
:func:`~ssds_tpu_torch.ops.cuda.stencil.row_stencil` and must be
bit-identical to the plain version on the card and on the CPU; the two dot
probes run through :func:`~ssds_tpu_torch.ops.cuda.conv.vconv3` and must be
within the tolerance of ``ssds_tpu_torch.ops.conv``. Each prints
``name: OK maxdiff=...`` with the kernel's and the plain version's times
(CUDA events) and its bound (its bytes once at the HBM rate, or its FLOPs at
the bf16 peak); where one PyTorch call computes the same function it is
checked and timed beside them as a yardstick (:func:`library_call`: cuDNN's
3x1 conv for the dot probes, ``F.pad`` or a copy for the one-term probes).
Any failure exits non-zero after every probe has run. At
bisect2's one block, where the host's launch decides, it also prints the
host microseconds per call of the wrapper and of the plain version
(:data:`HOST_PROBES`, 1,000 calls, one synchronise).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ssds_tpu_torch.ops.conv import ATOL, RTOL, vconv3_torch
from ssds_tpu_torch.ops.cuda.conv import vconv3
from ssds_tpu_torch.ops.cuda.stencil import row_stencil
from ssds_tpu_torch.ops.stencil import (DOT_PROBES, PROBES, TOOL_B, TOOL_C, TOOL_W,
                                        row_stencil_torch)
from ssds_tpu_torch.tools import card_line, host_us, need_cuda, roofline_ms, time_cuda

HOST_PROBES = ("pad_w", "pad_h")  # bisect2's block: ~2 us of device work a call


def timed(kernel, plain, iters, library=None):
    """(kernel ms, plain ms, library ms or None), each the faster of two turns
    in the order plain, kernel, library, library, kernel, plain."""
    turns = [plain, kernel] + ([library, library] if library else []) + [kernel, plain]
    ms = [time_cuda(fn, iters) for fn in turns]
    lib_ms = min(ms[2:4]) if library else None
    return min(ms[1], ms[-2]), min(ms[0], ms[-1]), lib_ms


def library_call(name, probe, x):
    """One PyTorch call computing a one-term probe's function (the JAX tool's
    pad and slice, or a copy), or None; the result may be a view."""
    if probe.terms != ((0, 0),):
        return None
    rows = x[:, :probe.out_rows]
    if name == "pad_h":
        return lambda: F.pad(x, (0, 0, 0, 0, 1, 1))[:, 1:probe.out_rows + 1]
    if "pad" in name:
        return lambda: F.pad(rows, (0, 0, 1, 1))[:, :, 1:-1]
    return lambda: rows.clone()


def cudnn_vconv3(xp, wd0):
    """cuDNN's bf16 3x1 conv on channels-last tensors: the same function as
    ``vconv3`` (weights ``[Cout, C, 3, 1]`` from the dy-stacked ``wd0``)."""
    c, cout = xp.shape[3], wd0.shape[1]
    w = wd0.reshape(3, c, cout).permute(2, 1, 0).unsqueeze(-1)
    w = w.contiguous(memory_format=torch.channels_last)
    x = xp.permute(0, 3, 1, 2)  # NCHW view of NHWC memory
    return lambda: F.conv2d(x, w).permute(0, 2, 3, 1)


def run(seed: int = 0, iters: int = 20, log=print) -> dict:
    """Every probe, checked and timed; raises after all ran if any failed."""
    dev = need_cuda("conv_probes")
    card = card_line()
    log(f"conv_probes: 17 stencil probes and 2 dot probes at the tools' sizes ({card})")
    inputs = {}

    def draw(shape):
        if shape not in inputs:
            x = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
            inputs[shape] = torch.from_numpy(x).to(torch.bfloat16)
        return inputs[shape]

    result, failed = {"card": card, "probes": {}}, []
    for name, probe in PROBES.items():
        x = draw(probe.shape)
        xc = x.to(dev)
        args = (probe.terms, probe.out_rows, probe.out_cols, probe.wmode)
        got = row_stencil(xc, *args)
        plain_card = row_stencil_torch(xc, *args).cpu()
        plain_cpu = row_stencil_torch(x, *args)
        got = got.cpu()
        maxdiff = max((got.float() - plain_card.float()).abs().max().item(),
                      (got.float() - plain_cpu.float()).abs().max().item())
        ok = torch.equal(got, plain_card) and torch.equal(got, plain_cpu)
        library = library_call(name, probe, xc)
        if library is not None and not torch.equal(library().cpu(), plain_card):
            raise SystemExit(f"conv_probes: the library call for {name} is not the probe's "
                             "function")
        k_ms, p_ms, l_ms = timed(lambda: row_stencil(xc, *args),
                                 lambda: row_stencil_torch(xc, *args), iters, library)
        bound_ms, bound_by = roofline_ms(0.0, 2 * (x.numel() + got.numel()))
        result["probes"][name] = {"source": probe.source, "shape": list(probe.shape),
                                  "max_abs_diff": maxdiff, "bit_identical": ok,
                                  "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                                  "bound_ms": bound_ms, "bound_by": bound_by}
        log(f"{name}: {'OK' if ok else 'FAIL'} maxdiff={maxdiff} (bit-identical to plain on "
            f"card and CPU: {ok})  {list(probe.shape)} -> "
            f"[{probe.shape[0]},{probe.out_rows},{probe.out_cols},{probe.shape[3]}]  "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
            f"{'none' if l_ms is None else f'{l_ms:.4f} ms'}, bound {bound_ms:.4f} ms ({bound_by})"
            f"  [{probe.source}]")
        if not ok:
            failed.append(name)
        if name in HOST_PROBES:
            k_us = host_us(lambda: row_stencil(xc, *args))
            p_us = host_us(lambda: row_stencil_torch(xc, *args))
            result["probes"][name].update(kernel_host_us=k_us, plain_host_us=p_us)
            log(f"{name}: host us per call (1000 calls, one sync): wrapper {k_us:.2f}, "
                f"plain {p_us:.2f}")
    stencil = [(p["kernel_ms"] / p["plain_ms"], n) for n, p in result["probes"].items()]
    result["slowest_vs_plain"] = max(stencil)[1]
    log(f"stencil probe slowest against plain: {result['slowest_vs_plain']} "
        f"(kernel / plain {max(stencil)[0]:.3f})")

    # tools/pallas_conv_bisect.py main(): x, then wd, from one generator
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (TOOL_B, 302, TOOL_W, TOOL_C)).astype(np.float32))
    wd = torch.from_numpy(rng.normal(0, 0.05, (3, 3 * TOOL_C, TOOL_C)).astype(np.float32))
    x, wd0 = x.to(torch.bfloat16), wd[0].to(torch.bfloat16)
    xc, wc = x.to(dev), wd0.to(dev)
    plain_cpu = vconv3_torch(x, wd0).float()
    cudnn = cudnn_vconv3(xc, wc)
    cudnn_err = (cudnn().float().cpu() - plain_cpu).abs().max().item()
    b, h2, w, c = x.shape
    flop = 2 * b * (h2 - 2) * w * 3 * c * c
    bound_ms, bound_by = roofline_ms(flop, 2 * (x.numel() + wd0.numel() + b * (h2 - 2) * w * c))
    for name, source in DOT_PROBES.items():
        got = vconv3(xc, wc).float().cpu()
        plain_card = vconv3_torch(xc, wc).float().cpu()
        maxdiff, ok = 0.0, True
        for ref in (plain_card, plain_cpu):
            maxdiff = max(maxdiff, (got - ref).abs().max().item())
            ok = ok and bool(torch.isclose(got, ref, rtol=RTOL, atol=ATOL).all())
        k_ms, p_ms, l_ms = timed(lambda: vconv3(xc, wc), lambda: vconv3_torch(xc, wc), iters,
                                 cudnn)
        result["probes"][name] = {"source": source, "shape": list(x.shape),
                                  "max_abs_diff": maxdiff, "within_tolerance": ok,
                                  "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                                  "library_max_abs_diff": cudnn_err, "bound_ms": bound_ms,
                                  "bound_by": bound_by}
        log(f"{name}: {'OK' if ok else 'FAIL'} maxdiff={maxdiff} (rtol 2^-7, atol 1e-4 against "
            f"plain on card and CPU: {ok})  {list(x.shape)} @ {list(wc.shape)}  "
            f"kernel {k_ms:.4f} ms, plain float32 {p_ms:.4f} ms, cuDNN bf16 (3,1) conv "
            f"{l_ms:.4f} ms (max |d| to plain {cudnn_err:.3e}), bound {bound_ms:.4f} ms "
            f"({bound_by})  [{source}]")
        if not ok:
            failed.append(name)
    log(f"({card})")
    if failed:
        raise SystemExit(f"conv_probes: {len(failed)} probe(s) failed: {failed}")
    return result


def main():
    run()


if __name__ == "__main__":
    main()
