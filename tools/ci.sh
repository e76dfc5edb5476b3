#!/usr/bin/env bash
# Local CI: full test suite on the virtual CPU mesh + entry-script checks.
# Usage: tools/ci.sh [--fast|--smoke]
#   --fast   skips tests marked slow
#   --smoke  <5 min fast-signal tier only (unit + cheap parity;
#            see tests/conftest.py _SMOKE_EXCLUDE)
set -euo pipefail
cd "$(dirname "$0")/.."

MARK=()
if [[ "${1:-}" == "--fast" ]]; then
  MARK=(-m "not slow")
elif [[ "${1:-}" == "--smoke" ]]; then
  MARK=(-m "smoke")
fi

echo "== pytest =="
python -m pytest tests/ -q "${MARK[@]}"

echo "== GPU entry scripts refuse the CPU =="
# bench.py and chip_smoke.py measure the card; without a GPU they must
# exit non-zero and print no result line.
for script in bench.py chip_smoke.py; do
  if out=$(JAX_PLATFORMS=cpu timeout 300 python "$script" 2>/dev/null); then
    echo "$script ran without a GPU"; exit 1
  fi
  if grep -q '"ok"\|"metric"' <<<"$out"; then
    echo "$script printed a result without a GPU"; exit 1
  fi
done
echo "GPU-only contract OK"

echo "== graft entry compile check =="
JAX_PLATFORMS=cpu python - <<'PY'
import jax
jax.config.update("jax_platforms", "cpu")
import __graft_entry__ as g
fn, args = g.entry()
jax.jit(fn).lower(*args).compile()
print("entry() compiles")
PY

echo "CI PASSED"
