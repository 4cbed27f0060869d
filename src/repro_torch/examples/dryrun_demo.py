"""Dry-run demo: trace a production-mesh train step as one chip's sharded
program and print its roofline terms: the flow `launch.dryrun --all` runs
for every (architecture x input shape). The twin of
`examples/dryrun_demo.py`.

An 8x8 mesh (64 ranks of a fake process group) and a 1024-token shape keep
the demo to seconds; the real campaigns use 16x16 and 2x16x16. No device
is touched: every number is a prediction against the H100's spec-sheet
peaks.

    PYTHONPATH=src python -m repro_torch.examples.dryrun_demo
"""
from repro_torch.configs import get_config
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_mesh


def main():
    # a small shape so the demo traces in seconds
    INPUT_SHAPES["demo_1k"] = InputShape("demo_1k", 1024, 32, "train")
    mesh = make_mesh((8, 8), ("data", "model"))
    cfg = get_config("qwen3-8b")
    lowered, meta = DR.build_lowered("qwen3-8b", "demo_1k", mesh, cfg=cfg)
    compiled = lowered.compile()
    rec = DR.analyse(lowered, compiled, meta, cfg)
    print(f"arch={rec['arch']} shape={rec['shape']} mesh={rec['mesh']}")
    print(f"  FLOPs/chip           {rec['hlo_flops_per_chip']:.3e}")
    print(f"  bytes/chip           {rec['hlo_bytes_per_chip']:.3e}")
    print(f"  collective B/chip    {rec['collective_bytes']['total']:.3e}")
    print(f"  roofline terms (s)   compute={rec['t_compute_s']:.4f} "
          f"memory={rec['t_memory_s']:.4f} "
          f"collective={rec['t_collective_s']:.4f}")
    print(f"  dominant term        {rec['dominant']}")
    print(f"  state bytes/chip     "
          f"{rec['memory'].get('argument_bytes', 0)/2**30:.2f} GiB")
    print(f"  peak bytes/chip      "
          f"{rec['memory'].get('peak_bytes', 0)/2**30:.2f} GiB")
    assert rec["hlo_flops_per_chip"] > 0
    print("dry-run demo OK")


if __name__ == "__main__":
    main()
