"""Benchmark/CLI rot guard: every script in benchmarks/ and every CLI
module must at least PARSE and byte-compile.

Round-1 lesson: benchmarks/bench_sharded.py carried an IndentationError for
days because nothing imported it (VERDICT round 1, weak #1).  Parsing is
cheap and catches exactly that class of rot without paying script runtime.
"""

import ast
import pathlib
import py_compile

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

SCRIPTS = sorted(
    list((REPO / "benchmarks").glob("*.py"))
    + [
        REPO / "bench.py",
        REPO / "chip_smoke.py",
        REPO / "crypto_rec_tpu" / "main.py",
        REPO / "crypto_rec_tpu" / "cluster_cli.py",
        REPO / "crypto_rec_tpu" / "serve_cli.py",
    ]
)


@pytest.mark.parametrize("path", SCRIPTS, ids=lambda p: str(p.relative_to(REPO)))
def test_script_parses(path, tmp_path):
    src = path.read_text()
    ast.parse(src, filename=str(path))
    py_compile.compile(str(path), cfile=str(tmp_path / "out.pyc"), doraise=True)


def test_cli_argparsers_build():
    """The CLI argument parsers must construct (no heavy imports needed)."""
    from crypto_rec_tpu.serve_cli import build_argparser

    p = build_argparser()
    args = p.parse_args(
        ["retrieve", "--index", "i", "--corpus", "c", "--queries", "q",
         "-o", "out"]
    )
    assert args.mode == "retrieve"
