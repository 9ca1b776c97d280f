"""The learning curve of an accuracy-proxy run, from its train log
(the model dir's ``log.json.lst``, json-lines: one row a logged step,
one row a periodic eval): t_err_gt at the first logged step and its
median over a step range, the loss and t_err_gt finite or not, and each
periodic eval's t_rel / r_rel / ATE.  Reads the port's logs
(``scripts/torch_accuracy_proxy.py``) and the JAX package's alike.

    python scripts/torch_proxy_curve.py LOG [LOG ...] [--lo 1000] [--hi 3000]
"""
import argparse
import json
import math
import statistics


def curve(path, lo=1000, hi=3000):
    """{"first": (step, t_err_gt), "median": (n, median t_err_gt over
    lo..hi), "finite": bool, "evals": [(step, t_rel, r_rel, ate)]}."""
    rows = [json.loads(line) for line in open(path) if line.strip()]
    train = [r for r in rows if "t_err_gt" in r]
    window = [r["t_err_gt"] for r in train if lo <= r["step"] <= hi]
    evals = [(r["step"], r["eval/t_rel_pct"], r["eval/r_rel_deg_per_100m"],
              r["eval/ate_rmse_m"]) for r in rows if "eval/ate_rmse_m" in r]
    return {"first": (train[0]["step"], train[0]["t_err_gt"]),
            "median": (len(window),
                       statistics.median(window) if window else None),
            "finite": all(math.isfinite(r[k]) for r in train
                          for k in ("loss", "t_err_gt")),
            "last_step": train[-1]["step"], "evals": evals}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("logs", nargs="+")
    ap.add_argument("--lo", type=int, default=1000)
    ap.add_argument("--hi", type=int, default=3000)
    args = ap.parse_args(argv)
    for path in args.logs:
        c = curve(path, args.lo, args.hi)
        n, med = c["median"]
        print(f"{path}: t_err_gt {c['first'][1]:.3f} m at step "
              f"{c['first'][0]}, median {med if med is None else round(med, 3)}"
              f" m over {n} logged steps in {args.lo}-{args.hi}; loss and "
              f"t_err_gt finite: {c['finite']}; last logged step "
              f"{c['last_step']}")
        for step, t, r, a in c["evals"]:
            print(f"  eval at step {step}: t_rel {t:.3f} %, r_rel {r:.3f} "
                  f"deg/100m, ATE {a:.3f} m")


if __name__ == "__main__":
    main()
