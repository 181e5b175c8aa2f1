"""Design-space exploration on the PyTorch port: pick an HBM-CO SKU and RPU
scale for YOUR model and latency/power target (the paper's §VII/§VIII
methodology as a tool).  ``examples/design_space.py`` on ``repro_torch``:
the same flags and the same output.

  PYTHONPATH=src python examples/torch_design_space.py --arch llama3-70b \
      --target-ms 0.5 --tdp-w 1000

Everything here is analytic (footprints, the HBM-CO design space, the
RPU simulator): it runs no model and touches no device, so ``--device``
is accepted, as by the other examples, and changes nothing.
"""
import argparse

from repro_torch.configs import get_config, list_configs
from repro_torch.core.hbmco import enumerate_design_space, pareto_frontier
from repro_torch.models.footprint import compute_footprint
from repro_torch.sim.scaling import min_cus_for_model, rpu_point


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-70b", choices=list_configs())
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=8192)
    ap.add_argument("--target-ms", type=float, default=None)
    ap.add_argument("--tdp-w", type=float, default=None)
    ap.add_argument("--device", default="cuda",
                    help="unused: the exploration is analytic")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    fp = compute_footprint(cfg)
    print(f"model {cfg.name}: {fp.total_params/1e9:.1f}B params "
          f"({fp.active_params/1e9:.1f}B active), "
          f"KV$ {fp.kv_bytes(args.batch, args.seq)/1e9:.2f} GB "
          f"at b={args.batch} s={args.seq}")

    print("\nfrontier SKUs:", ", ".join(
        f"{c.capacity_mb:.0f}MB/{c.energy_pj_per_bit:.2f}pJ"
        for c in pareto_frontier(enumerate_design_space())))

    n_min = min_cus_for_model(cfg, batch=args.batch, seq_len=args.seq)
    print(f"\n{'CUs':>6} {'SKU':>16} {'BW/Cap':>7} {'ms/tok':>8} "
          f"{'TDP W':>8} {'J/tok':>7} {'cost':>7}")
    chosen = None
    n = max(n_min, 8)
    while n <= 1024:
        p = rpu_point(cfg, n, batch=args.batch, seq_len=args.seq)
        if p is not None:
            print(f"{n:6d} {p.sku.name:>16} {p.sku.bw_per_cap:7.0f} "
                  f"{p.ms_per_token:8.3f} {p.tdp_w:8.0f} "
                  f"{p.sim.energy_j:7.2f} {p.cost:7.2f}")
            ok_lat = args.target_ms is None or p.ms_per_token <= args.target_ms
            ok_tdp = args.tdp_w is None or p.tdp_w <= args.tdp_w
            if ok_lat and ok_tdp and chosen is None:
                chosen = p
        n *= 2

    if args.target_ms or args.tdp_w:
        if chosen:
            print(f"\n==> pick {chosen.n_cus} CUs with {chosen.sku.name}: "
                  f"{chosen.ms_per_token:.3f} ms/tok at {chosen.tdp_w:.0f} W")
        else:
            print("\n==> no configuration meets the constraints; "
                  "relax --target-ms / raise --tdp-w")


if __name__ == "__main__":
    main()
