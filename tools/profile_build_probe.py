"""Two probes on the card, for ``chip_smoke.py``'s time:

* the kernel build with and without nvcc's ``--split-compile=0``, one
  after the other (each source's seconds, and its ptxas report of
  registers, spills and shared memory, printed per build: diff the
  ``[plain]`` and ``[split]`` lines);
* ``chip_smoke._events`` (the profile read from the raw kineto events)
  against ``prof.events()`` on a profiled train step of the narrowed f32
  smollm: device time by kernel name and host time of a few ops by name,
  and the seconds each read takes.

  python3 tools/profile_build_probe.py      # ~4 min on the H100, builds included
"""
import subprocess
import sys
import time
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
import torch
import chip_smoke as C
from repro_torch.kernels import _build as B

help_ = subprocess.run([B._nvcc(), "--help"], capture_output=True, text=True).stdout
print("split-compile in nvcc help:", "split-compile" in help_)
print(subprocess.run([B._nvcc(), "--version"], capture_output=True, text=True).stdout[-120:])
base = B.NVCC_FLAGS
B.SPLIT_COMPILE = ()        # each build's flags below apply to every source
for tag, flags in (("plain", base), ("split", base + ("--split-compile=0",))):
    B.NVCC_FLAGS = flags
    B.BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / f"k_{tag}"
    t0 = time.perf_counter()
    secs = B.build_all()
    print(f"[{tag}] build {time.perf_counter() - t0:.1f} s {secs}", flush=True)
    for name in secs:
        fn = ""
        for line in B.build_log(name).splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                print(f"[{tag}] {name}: {fn}: {line.strip()}")
B.NVCC_FLAGS = base
B.BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "k_plain"
B._LIBS.clear()

# profile equivalence on the card: a few train steps of the narrowed smollm
cfg = C._train_cfg(smoke=True)
from repro_torch.models.model import build_model
params = build_model(cfg, "cuda").init(torch.Generator(device="cuda").manual_seed(0))
step, opt, ds = C._trainer(cfg, "cuda", params, seq=128, batch=2, steps=3, lr=3e-3, warmup=1, seed=0)
params, opt, met, _ = step(params, opt, ds.batch(0))
torch.cuda.synchronize()
prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
prof.start(); params, opt, met, _ = step(params, opt, ds.batch(1)); float(met["loss"]); prof.stop()
t0 = time.perf_counter(); new = C.report_profile(prof, 1.0, 1, "probe (raw)"); t1 = time.perf_counter()
from torch.autograd import DeviceType
old = {}
for e in prof.events():
    if e.device_type != DeviceType.CUDA: continue
    n, t = old.get(e.name, (0, 0.0)); old[e.name] = (n + 1, t + e.self_device_time_total)
t2 = time.perf_counter()
diff = [k for k in set(old) | set(new) if k not in old or k not in new or old[k][0] != new[k][0] or abs(old[k][1] - new[k][1]) > 1e-3]
print(f"[probe] device names {len(new)} vs {len(old)}; differing {len(diff)} {diff[:3]}; busy {sum(t for _, t in new.values()):.3f} vs {sum(t for _, t in old.values()):.3f} us; raw {t1 - t0:.3f} s, parse {t2 - t1:.3f} s")
keys = ("aten::mm", "aten::add")
a = C._collective_ms(prof, keys)
b = {}
for e in prof.events():
    if not any(k in e.name.lower() for k in keys): continue
    n, t = b.get(e.name, (0, 0.0)); b[e.name] = (n + 1, t + e.cpu_time_total / 1e3)
print("[probe] host", {k: (a.get(k), b.get(k)) for k in sorted(set(a) | set(b))})
print("[probe] done")
