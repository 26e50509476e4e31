#!/usr/bin/env bash
# The runs that set a cell's bounds, on the card, in one call:
#   bash benchmark/sets.sh <cell> <seconds> "<6 seeds>" "<traced seeds>" "<more seeds>"
# set A and set B run the same 6 seeds (untraced), then the traced seeds
# with --trace 1, then the further seeds. Each run's standard output and
# error go to chiprun_out/sets/<cell>/<set>_<seed>.{out,err}; one line a
# run is printed: exit code, wall seconds, correct/attempted/failed, the
# metrics, the compared numbers, busy seconds and the memory peak. The
# first run that fails or comes out not correct ends the script.
cell=$1; secs=$2; set_seeds=$3; traced=$4; extra=$5
d=chiprun_out/sets/$cell; mkdir -p "$d"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
one() {
  tag=$1; seed=$2; tr=$3; s=$(date +%s.%N)
  timeout -s USR1 -k 15 345 python3 benchmark/run.py --workload "$cell" \
    --seed "$seed" --seconds "$secs" --trace "$tr" \
    > "$d/${tag}_$seed.out" 2> "$d/${tag}_$seed.err"
  rc=$?; e=$(date +%s.%N)
  python3 - "$d/${tag}_$seed.out" "$tag" "$seed" "$rc" "$s" "$e" <<'PY'
import json, sys
path, tag, seed, rc, s, e = sys.argv[1:]
lines = open(path).read().strip().splitlines()
r = json.loads(lines[-1]) if lines else {}
print(tag, seed, f"rc={rc}", "wall=%.1f" % (float(e) - float(s)),
      json.dumps({k: r.get(k) for k in ("correct", "attempted", "failed")}),
      json.dumps({k: v["value"] for k, v in r.get("metrics", {}).items()}),
      json.dumps({k: v["value"] for k, v in r.get("checks", {}).items()}),
      "busy", r.get("device", {}).get("busy_s"),
      "mem", r.get("device", {}).get("memory_peak_bytes"))
sys.exit(0 if rc == "0" and r.get("correct") is True else 1)
PY
  [ $? -eq 0 ] || { echo "stopped: $tag $seed failed"; exit 1; }
}
[ -n "$SKIP_A" ] || for s in $set_seeds; do one A "$s" 0; done
[ -n "$SKIP_B" ] || for s in $set_seeds; do one B "$s" 0; done
for s in $traced; do one T "$s" 1; done
for s in $extra; do one X "$s" 0; done
