"""The executable sidecar of the full-width Siamese artifact on the card:
compile seconds and package bytes of the fp32 and the int8 artifact at
batch 2, the package against the .pt2, bs-2 forward ms of each back to
back, and a fresh process's time to its first batch and device memory
through each (two turns); then the full-width discriminator compiled at
batch 2 and again at 4.  Card only, about 9 minutes of command:

    python3 tools/sidecar_probe.py
"""
import json, os, subprocess, sys, tempfile, time, zipfile
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke
from gan_aug_pfa_torch import serve
from gan_aug_pfa_torch.models import SiameseUNet

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip())
print(torch.__version__, torch.version.cuda, flush=True)
d = tempfile.mkdtemp()
model = chip_smoke.seeded_model(torch, SiameseUNet)
CHILD = r"""
import sys, time
t0 = time.perf_counter()
import torch
from gan_aug_pfa_torch import serve
torch.zeros(1, device="cuda"); torch.cuda.synchronize()
free0 = torch.cuda.mem_get_info()[0]
t1 = time.perf_counter()
h, fn = serve.load_serving_fn(sys.argv[1], aot=sys.argv[2], device="cuda")
g = torch.Generator().manual_seed(0)
xs = [torch.rand((2, 128, 128, 3), generator=g).cuda() for _ in range(2)]
y = fn(*xs); torch.cuda.synchronize(); t2 = time.perf_counter()
print("child aot=%s import+ctx %.2f s, load+first batch %.2f s, device bytes used %d, alloc %d" % (sys.argv[2], t1 - t0, t2 - t1, free0 - torch.cuda.mem_get_info()[0], torch.cuda.memory_allocated()))
"""
g = torch.Generator().manual_seed(1)
xs = [torch.rand((2, 128, 128, 3), generator=g).cuda() * 2 - 1 for _ in range(2)]
sizes = {}
for kind in ("fp32", "int8"):
    t0 = time.perf_counter()
    if kind == "int8":
        ex = serve.export_model_quantized("siamese", model.state_dict(), 128, 128, device="cuda")[0]
    else:
        ex = serve.export_model("siamese", model.state_dict(), 128, 128, device="cuda")
    path = os.path.join(d, f"s_{kind}.pt2")
    serve.save_artifact(path, ex, {"arch": "siamese"})
    print(kind, "export %.2f s, %d bytes" % (time.perf_counter() - t0, os.path.getsize(path)), flush=True)
    t0 = time.perf_counter()
    try:
        meta = serve.compile_artifact(path, [2], device="cuda")
    except Exception as e:
        import traceback; traceback.print_exc()
        print(kind, "COMPILE FAILED", flush=True)
        continue
    print(kind, "compile_artifact %.2f s" % (time.perf_counter() - t0), json.dumps(meta), flush=True)
    pkg = path + ".aotc.bs2.pt2"
    sizes[kind] = os.path.getsize(pkg)
    with zipfile.ZipFile(pkg) as z:
        for i in z.infolist():
            if i.file_size > 1e6:
                print("  ", i.filename, i.file_size, flush=True)
    h1, f1 = serve.load_serving_fn(path, aot="require", device="cuda")
    h2, f2 = serve.load_serving_fn(path, aot="never", device="cuda")
    print(h1)
    a, b = f1(*xs), f2(*xs)
    torch.cuda.synchronize()
    print(kind, "max |aoti - pt2|", float((a - b).abs().max()), a.shape, flush=True)
    for name, f in (("aoti", f1), ("pt2", f2), ("aoti", f1), ("pt2", f2)):
        for _ in range(5): f(*xs)
        torch.cuda.synchronize(); t0 = time.perf_counter()
        for _ in range(50): f(*xs)
        torch.cuda.synchronize()
        print(kind, name, "bs2 ms %.3f" % (1e3 * (time.perf_counter() - t0) / 50), flush=True)
    for aot in ("require", "never", "require", "never"):
        p = subprocess.run([sys.executable, "-c", CHILD, path, aot], capture_output=True, text=True)
        print(kind, p.stdout.strip(), p.stderr[-1500:] if p.returncode else "", flush=True)
print("int8/fp32 package bytes", sizes)
from gan_aug_pfa_torch.models import NLayerDiscriminator
torch.manual_seed(0)
disc = NLayerDiscriminator().eval()
path = os.path.join(d, "disc.pt2")
serve.save_artifact(path, serve.export_model("discriminator", disc.state_dict(), 256, 256, device="cuda"), {"arch": "discriminator"})
for sizes in ([2], [4]):
    t0 = time.perf_counter()
    meta = serve.compile_artifact(path, sizes, device="cuda")
    print("disc", sizes, "%.2f s" % (time.perf_counter() - t0), sorted(os.listdir(d)), flush=True)
