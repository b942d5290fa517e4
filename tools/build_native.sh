#!/bin/sh
# Build the native streaming runtime (libaruco3stream.so) into the
# gitignored aruco3_tpu/runtime/lib/.  runtime/stream.py runs this on first
# use when the library is missing.  The library is linked under a
# temporary name and renamed into place, so processes that build at the
# same time never load a half-written file.
set -e
cd "$(dirname "$0")/.."
mkdir -p aruco3_tpu/runtime/lib
out=aruco3_tpu/runtime/lib/libaruco3stream.so
tmp=$(mktemp "$out.XXXXXX")
trap 'rm -f "$tmp"' EXIT
g++ -O3 -shared -fPIC -std=c++17 -o "$tmp" native/stream_buffer.cpp
mv -f "$tmp" "$out"
echo "built $out"
