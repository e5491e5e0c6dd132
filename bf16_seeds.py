"""Phase 37 of chip_smoke.py (the card's bf16 VQ-VAE train step against the
CPU's and an fp64 step) at a range of data seeds, for the spread its
limits were set from. Needs one CUDA card and the kernels' build, as
chip_smoke.py does.

    python3 bf16_seeds.py [FIRST LAST]     # data seeds FIRST..LAST, default 9..16
"""

import json
import sys

import chip_smoke as cs


def main() -> None:
    first, last = (int(a) for a in sys.argv[1:3]) if len(sys.argv) > 2 else (9, 16)
    card = cs.phase_device()
    device = cs.cuda_device()
    cs.phase_build()
    rows = {}
    for seed in range(first, last + 1):
        r = cs.bf16_vs_cpu(device, seed)
        rows[seed] = {k: r[k] for k in ("full_ratio", "lin_ratio", "control_ratio", "direct_ratio")}
        rows[seed]["lin_cpu"] = r["lin"]["cpu"][0]
        rows[seed]["lin_fp32"] = r["lin"]["cuda_fp32"][0]
        print(f"[bf16 seeds] seed {seed}: with the model's loss card / cpu error against fp64 (median, all) "
              f"{', '.join(f'{v:.3f}' for v in r['full_ratio'])}; without the log term (median, all, worst) "
              f"{', '.join(f'{v:.3f}' for v in r['lin_ratio'])}, the cpu bf16 update {r['lin']['cpu'][0]:.3e} and "
              f"the card's fp32 one {r['lin']['cuda_fp32'][0]:.3e} from fp64's (median); control x "
              f"{cs.BF16_CONTROL_SCALE} {', '.join(f'{v:.3f}' for v in r['control_ratio'])}; card bf16 against cpu "
              f"bf16 over the cpu's own error {', '.join(f'{v:.3f}' for v in r['direct_ratio'])} [{card}]",
              flush=True)
    for key in ("full_ratio", "lin_ratio", "control_ratio", "direct_ratio"):
        cols = list(zip(*(row[key] for row in rows.values())))
        print(f"[bf16 seeds] {key} over seeds {first}-{last}: "
              + "; ".join(f"{min(c):.3f}-{max(c):.3f}" for c in cols) + f" [{card}]")
    print(json.dumps({"seeds": rows, "card": card}))


if __name__ == "__main__":
    main()
