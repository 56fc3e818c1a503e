"""Build the graph-control library and check its conditional nodes on the GPU.

    python3 tools/check_graph_control.py

Prints the CUDA toolkit, runtime and driver versions, then captures small
programs (mind_tpu_torch/ops/graph_control.py::GraphProgram) and holds each
replay against the same function run eagerly: a WHILE that counts a vector
up to per-entry limits (a body that allocates), an IF on a mask, an IF
nested in a WHILE whose body runs a cuBLAS product, a LayerNorm and a cuDNN
convolution, and replays under torch.cuda.set_sync_debug_mode("error") with
new inputs copied in between. Then the condition kernel alone against its
plain version (any(mask)) on masks of 1 to 4096 entries, and its time per
run inside a graph against `mask.any()`. Exits non-zero on any mismatch.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mind_tpu_torch.ops import graph_control as gc  # noqa: E402


def counting_program(dev):
    """A WHILE over x < limit, then an IF on flag; both bodies allocate."""
    x = torch.zeros(8, dtype=torch.float64, device=dev)
    limit = torch.zeros(8, dtype=torch.float64, device=dev)
    flag = torch.zeros(3, dtype=torch.bool, device=dev)
    y = torch.zeros(8, dtype=torch.float64, device=dev)
    trips = torch.zeros((), dtype=torch.int64, device=dev)

    def fn():
        def step():
            x.copy_(torch.where(x < limit, x + 1.0, x))
            trips.add_(1)
        gc.device_while(lambda: x < limit, step)
        gc.device_if(flag, lambda: y.copy_(x * 2.0 + 1.0))

    def load(lim, fl):
        x.zero_()
        y.zero_()
        trips.zero_()
        limit.copy_(lim)
        flag.copy_(fl)

    return fn, load, (x, y, trips)


def nested_program(dev):
    """A WHILE over rounds with an IF inside that runs library calls."""
    torch.manual_seed(0)
    lin = torch.nn.Linear(64, 64).to(dev)
    conv = torch.nn.Conv1d(16, 16, 3, padding=1).to(dev)
    norm = torch.nn.LayerNorm(64).to(dev)
    h = torch.randn(32, 64, device=dev)
    seq = torch.randn(4, 16, 20, device=dev)
    rnd = torch.zeros((), dtype=torch.int64, device=dev)
    n_rounds = torch.zeros((), dtype=torch.int64, device=dev)
    odd = torch.zeros((), dtype=torch.int64, device=dev)
    h0, seq0 = h.clone(), seq.clone()

    def fn():
        def round_():
            def inner():
                h.copy_(norm(torch.relu(lin(h))))
                seq.copy_(torch.tanh(conv(seq)))
                odd.add_(1)
            gc.device_if(rnd % 2 == 1, inner)
            rnd.add_(1)
        with torch.no_grad():
            gc.device_while(lambda: rnd < n_rounds, round_)

    def load(n):
        h.copy_(h0)
        seq.copy_(seq0)
        rnd.zero_()
        odd.zero_()
        n_rounds.fill_(n)

    return fn, load, (h, seq, rnd, odd)


def run_case(name, make, loads, dev):
    """Eager results for each load, then one program replayed for each."""
    fn, load, outs = make(dev)
    want = []
    for args in loads:
        load(*args)
        fn()
        want.append([o.clone() for o in outs])
    t = time.perf_counter()
    prog = gc.GraphProgram(fn, dev)
    capture_s = time.perf_counter() - t
    ok = True
    for args, w in zip(loads, want):
        load(*args)
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            prog.replay()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        torch.cuda.synchronize()
        same = all(torch.equal(o, e) for o, e in zip(outs, w))
        ok &= same
        print(f"[{name}] load {args}: replay equal to eager: {same}")
    print(f"[{name}] captured in {capture_s:.3f} s, {len(prog.bodies)} conditional bodies, "
          f"condition kernel runs {int(prog.executions)}")
    return ok, prog


def condition_kernel(dev):
    """The condition kernel alone: an IF whose body writes 1, per mask."""
    ok = True
    hit = torch.zeros((), dtype=torch.int64, device=dev)
    for n in (1, 60, 64, 255, 256, 257, 4096):
        mask = torch.zeros(n, dtype=torch.bool, device=dev)
        prog = gc.GraphProgram(lambda: gc.device_if(mask, lambda: hit.fill_(1)), dev)
        g = torch.Generator(device="cpu").manual_seed(n)
        cases = [torch.zeros(n, dtype=torch.bool), torch.arange(n) == n - 1,
                 torch.rand(n, generator=g) < 0.01]
        for c in cases:
            mask.copy_(c.to(dev))
            hit.zero_()
            prog.replay()
            got = bool(hit)
            want = bool(gc.set_conditional_any_ref(mask))
            ok &= got == want
        prog.close()
    print(f"[condition] any(mask) on masks of 1..4096 entries equal to the plain version: {ok}")
    # time: K condition kernels and one IF per replay
    K, reps = 200, 20
    mask = (torch.arange(60, device=dev) == 59)

    def many():
        for _ in range(K - 1):
            gc.device_if(mask, lambda: None)
        gc.device_if(mask, lambda: hit.add_(1))

    prog = gc.GraphProgram(many, dev)
    for _ in range(3):
        prog.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        prog.replay()
    end.record()
    torch.cuda.synchronize()
    per = start.elapsed_time(end) / reps / K
    start.record()
    for _ in range(reps * K):
        gc.set_conditional_any_ref(mask)
    end.record()
    torch.cuda.synchronize()
    plain = start.elapsed_time(end) / (reps * K)
    print(f"[condition] ms per condition kernel + IF node in a graph: {per:.5f}; "
          f"mask.any() eagerly: {plain:.5f}")
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("check_graph_control: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    nvcc = subprocess.run(["/usr/local/cuda/bin/nvcc", "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    print("nvcc:", nvcc[-1] if nvcc else "?")
    t = time.perf_counter()
    gc.load()
    print(f"graph_control built and loaded in {time.perf_counter() - t:.1f} s; "
          f"versions {gc.load.versions}")
    ok1, _ = run_case("while+if", counting_program,
                      [(torch.tensor([0, 1, 2, 3, 4, 5, 6, 7.]), torch.tensor([True, False, False])),
                       (torch.tensor([3.] * 8), torch.tensor([False] * 3)),
                       (torch.tensor([0.] * 8), torch.tensor([False, False, True]))], dev)
    ok2, prog = run_case("nested", nested_program, [(5,), (0,), (2,)], dev)
    with tempfile.TemporaryDirectory() as tmp:
        dot = Path(tmp) / "nested.dot"
        prog.dot(dot)
        text = dot.read_text()
    print(f"[nested] DOT: {len(text)} bytes, gemm kernels named {text.count('gemm')} times, "
          f"conditional nodes {text.count('CONDITIONAL')}")
    ok3 = condition_kernel(dev)
    print(f"launches of the condition kernel (captures): {gc.set_conditional_any.launches}")
    ok = ok1 and ok2 and ok3
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
