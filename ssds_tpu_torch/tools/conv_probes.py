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
(CUDA events); any failure exits non-zero after every probe has run.
"""

from __future__ import annotations

import numpy as np
import torch

from ssds_tpu_torch.ops.conv import ATOL, RTOL, vconv3_torch
from ssds_tpu_torch.ops.cuda.conv import vconv3
from ssds_tpu_torch.ops.cuda.stencil import row_stencil
from ssds_tpu_torch.ops.stencil import (DOT_PROBES, PROBES, TOOL_B, TOOL_C, TOOL_W,
                                        row_stencil_torch)
from ssds_tpu_torch.tools import card_line, need_cuda, time_cuda


def timed(kernel, plain, iters):
    """(kernel ms, plain ms), each the faster of plain, kernel, kernel, plain turns."""
    p_a, k_a = time_cuda(plain, iters), time_cuda(kernel, iters)
    k_b, p_b = time_cuda(kernel, iters), time_cuda(plain, iters)
    return min(k_a, k_b), min(p_a, p_b)


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
        k_ms, p_ms = timed(lambda: row_stencil(xc, *args), lambda: row_stencil_torch(xc, *args),
                           iters)
        result["probes"][name] = {"source": probe.source, "shape": list(probe.shape),
                                  "max_abs_diff": maxdiff, "bit_identical": ok,
                                  "kernel_ms": k_ms, "plain_ms": p_ms}
        log(f"{name}: {'OK' if ok else 'FAIL'} maxdiff={maxdiff} (bit-identical to plain on "
            f"card and CPU: {ok})  {list(probe.shape)} -> "
            f"[{probe.shape[0]},{probe.out_rows},{probe.out_cols},{probe.shape[3]}]  "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms  [{probe.source}]")
        if not ok:
            failed.append(name)

    # tools/pallas_conv_bisect.py main(): x, then wd, from one generator
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (TOOL_B, 302, TOOL_W, TOOL_C)).astype(np.float32))
    wd = torch.from_numpy(rng.normal(0, 0.05, (3, 3 * TOOL_C, TOOL_C)).astype(np.float32))
    x, wd0 = x.to(torch.bfloat16), wd[0].to(torch.bfloat16)
    xc, wc = x.to(dev), wd0.to(dev)
    plain_cpu = vconv3_torch(x, wd0).float()
    for name, source in DOT_PROBES.items():
        got = vconv3(xc, wc).float().cpu()
        plain_card = vconv3_torch(xc, wc).float().cpu()
        maxdiff, ok = 0.0, True
        for ref in (plain_card, plain_cpu):
            maxdiff = max(maxdiff, (got - ref).abs().max().item())
            ok = ok and bool(torch.isclose(got, ref, rtol=RTOL, atol=ATOL).all())
        k_ms, p_ms = timed(lambda: vconv3(xc, wc), lambda: vconv3_torch(xc, wc), iters)
        result["probes"][name] = {"source": source, "shape": list(x.shape),
                                  "max_abs_diff": maxdiff, "within_tolerance": ok,
                                  "kernel_ms": k_ms, "plain_ms": p_ms}
        log(f"{name}: {'OK' if ok else 'FAIL'} maxdiff={maxdiff} (rtol 2^-7, atol 1e-4 against "
            f"plain on card and CPU: {ok})  {list(x.shape)} @ {list(wc.shape)}  "
            f"kernel {k_ms:.4f} ms, plain float32 {p_ms:.4f} ms  [{source}]")
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
