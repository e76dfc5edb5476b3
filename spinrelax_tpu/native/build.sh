#!/bin/bash
# Build the native libraries ahead of first use, with the loader's own
# compiler command and output paths (io/native.py: build/lib<name>-<key>.so).
set -e
cd "$(dirname "$0")/../.."
python -c "
from spinrelax_tpu.io import native
for name in ('fastio', 'xtc'):
    print('built', native.ensure_built(name))
"
