"""Print the periodic-eval metric trend of one or more proxy model dirs
(step vs t_rel / r_rel / ATE / frame errors) from log.json.lst: the
matched-budget comparison view (pillar@N vs sparse@N).  The twin of
``scripts/eval_trend.py`` for the port's model dirs, whose logger
writes the eval hook's rows as ``eval/<metric>`` keys, as JAX's does.

    python scripts/torch_eval_trend.py <model_dir> [<model_dir> ...]

It reads the logs on the host (no ``--device``).
"""
import json
import sys
from pathlib import Path


def rows(mdir: Path):
    f = mdir / "log.json.lst"
    if not f.exists():
        return []
    out = []
    for line in f.read_text().splitlines():
        try:
            d = json.loads(line)
        except json.JSONDecodeError:
            continue
        if any("t_rel" in k for k in d):
            out.append(d)
    return out


def main(dirs):
    for mdir in map(Path, dirs):
        print(f"== {mdir.name}")
        print(f"{'step':>6s} {'t_rel%':>8s} {'r_rel':>8s} {'ATE':>8s} "
              f"{'t_err':>7s} {'q_err':>7s}")
        for d in rows(mdir):
            def g(k):
                return next((v for kk, v in d.items() if k in kk),
                            float("nan"))
            print(f"{d.get('step', -1):6d} {g('t_rel'):8.2f} "
                  f"{g('r_rel'):8.2f} {g('ate'):8.2f} "
                  f"{g('frame_t_err'):7.3f} {g('frame_q_err'):7.3f}")


if __name__ == "__main__":
    main(sys.argv[1:])
