# Build / test entry points (the analog of the reference's
# scripts/10..17 build scripts).

CXX ?= g++
# Same flags as the on-demand builder (native/__init__.py _build).
CXXFLAGS ?= -O3 -march=native -funroll-loops -shared -fPIC -std=c++17

native: stringsext_tpu/native/libemitter.so

stringsext_tpu/native/libemitter.so: stringsext_tpu/native/emitter.cpp
	$(CXX) $(CXXFLAGS) -o $@ $<

test: native
	python -m pytest tests/ -x -q

bench: native
	python bench.py

# Device-engine smoke on an NVIDIA GPU: the normal CLI end to end on
# the card, checked against the host engine, the Python oracle and the
# jnp lanes; one JSON line last. Fails without a GPU.
chip-smoke:
	python chip_smoke.py

fuzz: native
	python scripts/fuzz.py 300

# Memory-safety fuzz of the C++ engine: rebuild instrumented, run the
# differential fuzzer with every jax-tracing path disabled (ASan's
# __cxa_throw interceptor CHECK-fails inside jaxlib's MLIR bindings -
# a jaxlib/ASan incompatibility, not a bug here), restore the
# optimized build afterwards.
ASAN_RT := $(shell g++ -print-file-name=libasan.so)
asan-fuzz:
	$(CXX) -O1 -g -fsanitize=address,undefined -fno-omit-frame-pointer \
	  -march=native -shared -fPIC -std=c++17 \
	  -o stringsext_tpu/native/libemitter.so stringsext_tpu/native/emitter.cpp
	STRINGSEXT_FUZZ_ENGINES=python,auto LD_PRELOAD=$(ASAN_RT) \
	  ASAN_OPTIONS=detect_leaks=0:log_path=/tmp/asan_fuzz \
	  python scripts/fuzz.py 600; \
	status=$$?; $(MAKE) clean native; exit $$status

packages:
	python scripts/build_packages.py

man: docs/stringsext-tpu.1

docs/stringsext-tpu.1: docs/MANUAL.md scripts/make_man.py
	python scripts/make_man.py

clean:
	rm -f stringsext_tpu/native/libemitter.so

.PHONY: native test bench chip-smoke fuzz asan-fuzz man packages clean
