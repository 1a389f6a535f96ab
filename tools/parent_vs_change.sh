#!/bin/bash
# Compares a parent commit and a change on one card in one call:
# chip_smoke.py from two checkouts in the order parent, change, change,
# parent (a drift of the card or the host over the call then shows as a
# difference between the two runs of one side), the change's GPU tests
# between the change's two runs, every log written to OUT_DIR. Prints the
# card's name and power limit, each run's exit code, then from each log the
# lines the two are compared on: the SwiGLU, film-layer, fused attention and
# prologue kernels at their main shapes, K4's plans, the profiled request's
# device time, the train steps (also with the prologue on) and the wall. After each smoke run, tools/step_profile.py (this
# tree's copy, from that checkout) times the FFN backward kernels by graph
# replay and profiles one train step of each stage, so that both trees are
# measured by the same code; its lines close each block.
#
#   tools/parent_vs_change.sh PARENT_DIR CHANGE_DIR OUT_DIR
#
# Make the checkouts with `git archive` into directories that .gitignore
# lists, e.g. `git archive HEAD~1 | tar -x -C build/parent`.
set -u
if [ $# -ne 3 ]; then
  echo "usage: $0 PARENT_DIR CHANGE_DIR OUT_DIR" >&2
  exit 2
fi
parent=$(realpath "$1")
change=$(realpath "$2")
out=$(realpath -m "$3")
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
status=0
tool=$(realpath "$(dirname "$0")/step_profile.py")
smoke() {
  (cd "$1" && python3 chip_smoke.py > "$out/$2.log" 2>&1)
  local rc=$?
  echo "$2: chip_smoke.py rc $rc"
  [ $rc -eq 0 ] || status=1
  (cd "$1" && python3 "$tool" > "$out/$2_steps.log" 2>&1)
  rc=$?
  echo "$2: step_profile.py rc $rc"
  [ $rc -eq 0 ] || status=1
}
smoke "$parent" parent1
smoke "$change" change1
(cd "$change" && python3 -m pytest tests/test_torch_kernels_gpu.py -m gpu -q -p no:cacheprovider \
  > "$out/gpu_tests.log" 2>&1)
rc=$?
echo "change: GPU tests rc $rc, $(tail -1 "$out/gpu_tests.log")"
[ $rc -eq 0 ] || status=1
smoke "$change" change2
smoke "$parent" parent2
main='^(swiglu|film_layer) B(4 L759 C512|128 L152 C512 \(training\)|4 L20493 FiLM|64 L1026 FiLM \(latent training\)): kernel|^fused_attention_(fwd|bwd) B128 L152 H16: kernel|^film_qkv_(fwd|bwd) B128 L152 C512 F3072( \(training\))?: kernel'
for run in parent1 change1 change2 parent2; do
  echo "== $run"
  grep -E "$main|^swiglu plan|that request on the device|^fit-(denoiser|latent)(, fused prologue, width 512)? \(|^fit-denoiser, fused prologue, width 512: one step|chip_smoke wall time" \
    "$out/$run.log" | cut -c1-400
  grep -E "^K([1356]|9|10|11|12) |one step under" "$out/${run}_steps.log" | cut -c1-400
done
exit $status
