#!/bin/sh
# Build the native .bed decoder shared library.
set -e
cd "$(dirname "$0")/../nldsc_jax/native"
make
echo "built: $(pwd)/libbed_decode.so"
