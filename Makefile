# Developer entry points (reference Makefile:61-68 `make format` analog;
# lint configuration lives in pyproject.toml [tool.ruff]).

.PHONY: all native test lint format asm clean

all: native

native:
	$(MAKE) -C sparsebench/native

test:
	python -m pytest tests/ -x -q

# ruff when available (full rule set, pyproject [tool.ruff]); otherwise
# fall back to a byte-compile pass so `make lint` still catches syntax
# errors in environments without ruff (like the dev image).
lint:
	@if command -v ruff >/dev/null 2>&1; then \
		ruff check sparsebench tests tools bench.py \
			__graft_entry__.py; \
	else \
		echo "ruff not installed; falling back to compileall"; \
		python -m compileall -q sparsebench tests tools bench.py \
			__graft_entry__.py; \
	fi

format:
	@command -v ruff >/dev/null 2>&1 || { echo "ruff not installed"; exit 1; }
	ruff check --fix sparsebench tests tools bench.py __graft_entry__.py
	ruff format sparsebench tests tools bench.py __graft_entry__.py

# reference `make asm` analog (Makefile:26-30): dump lowered + optimized
# HLO for the hot solves into build/asm/
asm:
	python tools/dump_hlo.py

clean:
	$(MAKE) -C sparsebench/native clean
