"""What every cell shares: its parts found by name, the dataset cache, the
weights made from the seed, the program built from them, and the device
record.

A cell `<cell>` of BENCHMARK.json has `workloads/<cell>.yaml`; it names a
configuration `configs/<config>.yaml` (with `configs/<config>.py`, the
FLOPs of one step, and `reference/<config>.py`, its plain reference) and a
traffic mix `traffic/<mix>.yaml`, whose `kind` names the loop
`traffic/<kind>.py`. A metric `<metric>` is read by `metrics/<metric>.py`.
Adding any of them edits no existing file.
"""

import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

import yaml

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
CACHE = os.path.join(PKG, ".cache")
# top-level module names that no run may hold: JAX, and the JAX package
# that the port ports (compared whole: foodrec_tpu_torch is not one of them)
FOREIGN = ("jax", "jaxlib", "flax", "foodrec_tpu")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def load_yaml(path):
    with open(path) as f:
        return yaml.safe_load(f)


def load_module(path):
    """The module of a file under the benchmark's folder (names may hold
    dots and dashes)."""
    name = "portbench._by_path." + os.path.relpath(path, PKG).replace(
        os.sep, ".").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One entry of BENCHMARK.json's workloads and every part it names."""

    def __init__(self, name, bench=None):
        bench = bench or benchmark()
        entry = {w["name"]: w for w in bench["workloads"]}.get(name)
        if entry is None:
            raise ValueError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.spec = load_yaml(os.path.join(PKG, "workloads", name + ".yaml"))
        for key in ("config", "traffic", "chips", "why"):
            if self.spec[key] != entry[key]:
                raise ValueError(f"workloads/{name}.yaml has {key} "
                                 f"{self.spec[key]!r}, BENCHMARK.json "
                                 f"{entry[key]!r}")
        self.chips = entry["chips"]
        self.config_name = entry["config"]
        self.config = load_yaml(
            os.path.join(PKG, "configs", self.config_name + ".yaml"))
        self.traffic = load_yaml(
            os.path.join(PKG, "traffic", entry["traffic"] + ".yaml"))
        self.limits = {k: float(v) for k, v in self.spec["limits"].items()}
        self.kind = load_module(
            os.path.join(PKG, "traffic", self.traffic["kind"] + ".py"))
        self.flops = load_module(
            os.path.join(PKG, "configs", self.config_name + ".py"))
        self.reference = load_module(
            os.path.join(PKG, "reference", self.config_name + ".py"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if _applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _applies(m, name)]

    def metric_module(self, name):
        return load_module(os.path.join(PKG, "metrics", name + ".py"))


def cache_environment():
    """Every build and kernel cache inside the checkout, at fixed paths.
    The port builds its CUDA kernels into build/kernels/ of the checkout by
    itself; these cover what PyTorch and CUDA would cache."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"


def dataset(config):
    """The directory holding the configuration's dataset, generated by the
    frozen generator on the first run in a checkout and read afterwards;
    keyed by the generator's parameters."""
    data = config["data"]
    key = hashlib.sha256(json.dumps(data, sort_keys=True).encode()).hexdigest()
    root = os.path.join(CACHE, "data", key[:16])
    done = os.path.join(root, data["name"], "processed_dataset",
                        "_GEN_COMPLETE")
    if not os.path.exists(done):
        from portbench.data import synthetic

        partial = root + ".partial"
        shutil.rmtree(partial, ignore_errors=True)
        t = time.perf_counter()
        info = synthetic.generate(os.path.join(partial, data["name"]),
                                  **data["params"])
        shutil.rmtree(root, ignore_errors=True)
        os.replace(partial, root)
        log(f"[data] generated {data['name']} {info} in "
            f"{time.perf_counter() - t:.1f} s")
    return root


def shapes_of(config):
    """The sizes the configuration's parameters take, from its data
    parameters."""
    p = config["data"]["params"]
    return {"n_users": p["n_users"], "n_items": p["n_items"],
            "n_ingredients": p["n_ingredients"], "img_dim": p["img_dim"],
            "txt_dim": p["txt_dim"], "n_health": p["n_health_levels"]}


def foreign_modules():
    """Top-level names in sys.modules that no run may hold."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)}
                  & set(FOREIGN))


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Context:
    """One run of one cell: its parts, seed, device and dataset."""

    def __init__(self, cell, seed, device):
        self.cell = cell
        self.seed = int(seed)
        self.device = device
        self.config = cell.config
        self.traffic = cell.traffic
        self.data_root = dataset(cell.config)
        self.shapes = shapes_of(cell.config)

    def weights(self):
        """The weights of this seed, made on the device in one draw: every
        parameter but the dataset's feature tables."""
        from portbench.reference import plain

        spec = self.cell.reference.init_spec(self.shapes,
                                             self.config["model_config"])
        return plain.make_weights(spec, self.seed, self.device)

    def reference_weights(self, weights, data):
        """`weights` (copied) with the dataset's feature tables, read from
        its files: what the reference starts from."""
        from portbench.reference import plain

        spec = self.cell.reference.init_spec(self.shapes,
                                             self.config["model_config"])
        tables = plain.make_weights([s for s in spec if s[2] == "table"],
                                    self.seed, self.device, data)
        return {name: (tables[name] if name in tables
                       else weights[name].clone())
                for name, _, _, _ in spec}

    def build_program(self, weights):
        """The port's config, dataset and model, the model's parameters set
        to `weights` (its feature tables are its own, from the dataset)."""
        import torch
        from foodrec_tpu_torch.config import Config
        from foodrec_tpu_torch.data.dataset import FoodData, derive_data_paths
        from foodrec_tpu_torch.data.device import DeviceData
        from foodrec_tpu_torch.models import get_model

        c = self.config
        t = time.perf_counter()
        cfg = Config(c["model"], c["data"]["name"], {
            **c["model_config"], "data_path": self.data_root + "/",
            "seed": self.seed, "use_gpu": self.device != "cpu"})
        derive_data_paths(cfg, c["data"]["name"])
        fd = FoodData(cfg)
        fd.device_data = DeviceData.from_food_data(fd)
        log(f"[setup] the program read the dataset in "
            f"{time.perf_counter() - t:.3f} s")
        t = time.perf_counter()
        model = get_model(c["model"])(cfg, fd,
                                      torch.Generator().manual_seed(self.seed))
        log(f"[setup] the program built its model in "
            f"{time.perf_counter() - t:.3f} s")
        spec = {n: s for n, s, _, _ in self.cell.reference.init_spec(
            self.shapes, c["model_config"])}
        params = dict(model.named_parameters())
        if set(params) != set(spec):
            raise ValueError(f"the program's parameters {sorted(params)} "
                             f"are not the reference's {sorted(spec)}")
        with torch.no_grad():
            for name, p in params.items():
                if tuple(p.shape) != tuple(spec[name]):
                    raise ValueError(f"{name}: {tuple(p.shape)} in the "
                                     f"program, {spec[name]} in the reference")
                if name in weights:
                    p.copy_(weights[name])
        return cfg, fd, model


def nvidia_smi(query):
    """One reading of nvidia-smi for card 0, as strings; None where
    nvidia-smi does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,"
             "nounits", "-i", "0"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0 or not out.stdout.strip():
        return None
    return [v.strip() for v in out.stdout.strip().splitlines()[0].split(",")]


class SmiSampler:
    """nvidia-smi's SM clock, power draw and temperature every 5 seconds
    beside the window, in a process of its own that stop() ends."""

    FIELDS = "clocks.sm,power.draw,temperature.gpu"

    def __init__(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={self.FIELDS}",
                 "--format=csv,noheader,nounits", "-i", "0", "-lms", "5000"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None

    def stop(self):
        """[(sm MHz, W, C)] read while it ran."""
        if self.proc is None:
            return []
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        rows = []
        for line in out.splitlines():
            try:
                rows.append(tuple(float(v) for v in line.split(",")))
            except ValueError:
                continue
        return rows


def device_record(chips):
    """The device block of the result: the card's name, the cards used,
    the process's peak of device memory, and the card's power limit."""
    import torch

    lim = nvidia_smi("power.limit")
    try:
        limit = float(lim[0]) if lim else None
    except ValueError:
        limit = None
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
            "power_limit_w": limit}
