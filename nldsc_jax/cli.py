"""Command-line interface.

Flag-for-flag compatible with the reference CLI (``nldsc/__main__.py``),
with the reference's quirks fixed (SURVEY Q8-Q10):

* ``.M`` / ``.M_5_50`` sidecars are actually written
* ``--use-M`` is forwarded to the h2 pipeline
* ``-maf`` has a real default (1e-5) instead of crashing when omitted
* ``--std-thr`` default unified to the CLI value 1e-4
"""

from __future__ import annotations

import argparse
import sys

from .core.logging import enable_file_logging, log
from .version import __version__

__header__ = (
    f"\n==============================================================\n"
    f"* Non-additive LD Score Regression (nldsc-jax)\tv{__version__}\n"
    f"* JAX reimplementation of nldsc (bayarpark/nldsc)\n"
    f"* JAX/XLA engine; GNU General Public License v3\n"
    f"==============================================================\n"
)

SHARD_AXES = ("snp", "samples", "grid")


def _window(args) -> tuple[str, float]:
    if sum(map(bool, [args.ld_wind_kb, args.ld_wind_cm])) != 1:
        raise RuntimeError("Please, specify exactly one --ld-wind option")
    if args.ld_wind_kb:
        return "kbp", args.ld_wind_kb
    return "cm", args.ld_wind_cm


def est_ld(args) -> None:
    wind_metric, ld_wind = _window(args)
    use_int8 = None if args.engine is None else args.engine != "f32"

    from .ld.pipeline import estimate_lds  # noqa: PLC0415

    df = estimate_lds(
        args.bfile, ld_wind=ld_wind, wind_metric=wind_metric,
        maf_thr=args.maf_thr, std_thr=args.std_thr, rsq_thr=args.rsq_thr,
        out=args.out, extra=args.extra, summary=True,
        block_size=args.block_size, use_int8=use_int8,
        symmetric=args.symmetric, int8_dot_dtype=args.dot_dtype,
        split_missing=args.split_missing,
        n_devices=args.n_devices, shard_samples=(args.shard_axis == "samples"),
        shard_grid=(args.shard_axis == "grid"),
        profile_dir=args.profile_dir,
        streaming=args.streaming, chunk_rows=args.chunk_rows,
        resume_path=args.resume_path, annot=args.annot,
        progress=args.progress,
    )
    if df is not None and args.out is None:
        print(df.to_string(max_rows=40))


def est_ld_genome(args) -> None:
    import glob as globmod  # noqa: PLC0415
    import os  # noqa: PLC0415
    import re  # noqa: PLC0415

    wind_metric, ld_wind = _window(args)
    bfiles = args.bfiles
    if "," in bfiles:
        paths = [p.strip() for p in bfiles.split(",") if p.strip()]
    elif globmod.has_magic(bfiles):
        paths = sorted(globmod.glob(bfiles))
        if not paths:
            raise RuntimeError(f"No bfiles match {bfiles!r}")
    else:
        paths = [bfiles]
    prefixes = sorted({re.sub(r"\.(bed|bim|fam)$", "", p) for p in paths})
    names = [os.path.basename(p) for p in prefixes]
    if len(set(names)) != len(names):
        dups = sorted({n for n in names if names.count(n) > 1})
        raise RuntimeError(
            "bfile prefixes with identical basenames would overwrite each "
            f"other's outputs in --out-dir: {dups}")

    from .ld.pipeline import estimate_lds  # noqa: PLC0415
    from .parallel.distributed import assign_chromosomes  # noqa: PLC0415

    mine = assign_chromosomes(prefixes)
    os.makedirs(args.out_dir, exist_ok=True)
    log.info("ld-genome: %d bfiles total, %d on this host", len(prefixes),
             len(mine))
    for i, prefix in enumerate(mine):
        out = os.path.join(args.out_dir, os.path.basename(prefix) + ".L2")
        log.info("[%d/%d] %s -> %s", i + 1, len(mine), prefix, out)
        resume_path = (os.path.join(args.resume_dir, os.path.basename(prefix))
                       if args.resume_dir else None)
        estimate_lds(prefix, ld_wind=ld_wind, wind_metric=wind_metric,
                     maf_thr=args.maf_thr, std_thr=args.std_thr,
                     rsq_thr=args.rsq_thr, out=out, extra=args.extra,
                     streaming=args.streaming, chunk_rows=args.chunk_rows,
                     n_devices=args.n_devices,
                     shard_samples=(args.shard_axis == "samples"),
                     shard_grid=(args.shard_axis == "grid"),
                     annot=args.annot, resume_path=resume_path,
                     bucket_shapes=args.bucket_shapes)
    log.info("ld-genome: %d chromosomes done", len(mine))


def est_h2(args) -> None:
    if args.partitioned:
        from .h2.pipeline import estimate_h2_partitioned  # noqa: PLC0415

        estimate_h2_partitioned(
            sumstats=args.sumstats, ref_ld=args.ref_ld, w_ld=args.w_ld,
            n_blocks=args.n_blocks, intercept_h2=args.intercept_h2,
            chisq_max=args.chisq_max, use_m=args.use_m,
            save_to_json=args.save_to_json, on_device=args.on_device)
        return

    from .h2.pipeline import estimate_h2  # noqa: PLC0415

    estimate_h2(
        sumstats=args.sumstats, ldscore=args.ref_ld, n_blocks=args.n_blocks,
        intercept_h2=args.intercept_h2, chisq_max=args.chisq_max,
        use_m=args.use_m, two_step=args.two_step, strategy=args.strategy,
        save_to_json=args.save_to_json, samp_prev=args.samp_prev,
        pop_prev=args.pop_prev,
        w_ldscore=args.w_ld if args.w_ld != args.ref_ld else None,
        on_device=args.on_device)


def convert(args) -> None:
    from .io.convert import from_ldsc, to_ldsc  # noqa: PLC0415

    if (args.to_ldsc is None) == (args.from_ldsc is None):
        raise RuntimeError("Specify exactly one of --to-ldsc / --from-ldsc")
    if args.to_ldsc is not None:
        if args.input is None:
            raise RuntimeError("--to-ldsc requires -i/--input <file.L2>")
        to_ldsc(args.input, args.to_ldsc)
    else:
        if args.out is None:
            raise RuntimeError("--from-ldsc requires -o/--out <file.L2>")
        from_ldsc(args.from_ldsc, args.out)


def _window_args(p: argparse.ArgumentParser, long_help: bool) -> None:
    p.add_argument("-kb", "--ld-wind-kb", metavar="W", type=float,
                   help="Window size for LD score estimation in kilo-base "
                        "pairs (kb)" if long_help else
                        "Window size in kilo-base pairs (kb)")
    p.add_argument("-cm", "--ld-wind-cm", metavar="W", type=float,
                   help="Window size for LD score estimation in "
                        "centi-morgans (cM)" if long_help else
                        "Window size in centi-morgans (cM)")
    p.add_argument("-maf", "--maf-thr", metavar="F", type=float, default=1e-5,
                   help="Minor allele frequency threshold (lower bound)")
    p.add_argument("-std", "--std-thr", metavar="F", type=float, default=1e-4,
                   help="Standard deviation threshold for regression "
                        "residuals")
    p.add_argument("-rsq", "--rsq-thr", metavar="F", type=float, default=None,
                   help="R-squared threshold for regression residuals "
                        "(affects dominant window sizes / MD). "
                        "Default: 1/n_snp")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="nldsc-jax", allow_abbrev=False)
    parser.add_argument("--version", action="version",
                        version=f"%(prog)s {__version__}")
    parser.add_argument("--log-file", action="store_true",
                        help="Also log to ./nldsc.log")
    sub = parser.add_subparsers(dest="command", required=True)
    flag = argparse.BooleanOptionalAction

    def command(name, func, help_):
        p = sub.add_parser(name, help=help_, description=help_,
                           allow_abbrev=False)
        p.set_defaults(func=func)
        p.add_argument("--display", action="store_true",
                       help="Display traceback")
        return p

    p = command("ld", est_ld, "Estimate additive and non-additive LD Scores")
    p.add_argument("--bfile", metavar="FILE", required=True,
                   help="Path prefix for PLINK .bed/.bim/.fam file or path "
                        "to one of them")
    p.add_argument("-o", "--out", metavar="FILE",
                   help="Path prefix for output. If not specified the "
                        "table is printed")
    _window_args(p, long_help=True)
    p.add_argument("--extra", action="store_true",
                   help="Include additional information (MAF WSA WSD WSDE "
                        "RSTD) in the .L2 file")
    p.add_argument("--block-size", metavar="B", type=int, default=512,
                   help="SNP rows per device tile")
    p.add_argument("--engine", choices=["int8", "f32"], default=None,
                   help="Compute engine: integer-exact int8 (default) or "
                        "f32 slab matmuls")
    p.add_argument("--symmetric", action=flag, default=None,
                   help="Exploit r-squared symmetry (half-band, default on; "
                        "--no-symmetric forces the full-band engine)")
    p.add_argument("--dot-dtype", choices=["int8", "bf16"], default="int8",
                   help="Contraction dtype for the integer engines (both "
                        "are exact for genotype codes)")
    p.add_argument("--split-missing", action=flag, default=None,
                   help="Per-row missing-data specialization: clean-rate "
                        "pass + exact compact corrections (default: auto, "
                        "on when <=25%% of rows carry missing genotypes)")
    p.add_argument("--n-devices", metavar="N", type=int, default=None,
                   help="Shard the SNP axis over N devices (default: all "
                        "local devices when more than one is visible)")
    p.add_argument("--shard-axis", choices=SHARD_AXES, default="snp",
                   help="Multi-device axis: 'snp' (halo-exchange SNP "
                        "blocks, default), 'samples' (per-tile psum'd "
                        "sample shards — for huge N; composes with "
                        "--streaming), or 'grid' (2-D snp-x-sample mesh; "
                        "with --streaming, chunks round-robin over mesh "
                        "rows while each row sample-shards its chunk)")
    p.add_argument("--profile-dir", metavar="DIR", default=None,
                   help="Capture a jax.profiler trace of the compute pass "
                        "into this directory")
    p.add_argument("--streaming", action=flag, default=None,
                   help="Force the out-of-core engine on/off (default: "
                        "auto by memory footprint)")
    p.add_argument("--chunk-rows", metavar="R", type=int, default=8192,
                   help="Pivot rows per streaming chunk")
    p.add_argument("--resume", dest="resume_path", metavar="DIR",
                   default=None,
                   help="Checkpoint directory for chunk-granular resume "
                        "(streaming; one shard file per completed chunk)")
    p.add_argument("--annot", metavar="FILE", default=None,
                   help="Per-SNP annotation file (SNP column + one column "
                        "per annotation): compute PARTITIONED LD scores "
                        "(<name>.L2 / <name>.L2D per annotation)")
    p.add_argument("--progress", action=flag, default=None,
                   help="Percent/ETA progress during the LD pass (default: "
                        "on for runs above 20k SNPs; streaming always logs "
                        "chunks)")

    p = command("ld-genome", est_ld_genome,
                "Run `ld` over MANY single-chromosome bfiles (glob or comma "
                "list), one .L2 per bfile. In a multi-host job "
                "(jax.distributed) the chromosomes round-robin over hosts "
                "— the job-level scale-out matching the reference's "
                "one-file-per-chromosome model")
    p.add_argument("--bfiles", metavar="GLOB", required=True,
                   help="Glob or comma-separated list of bfile prefixes (or "
                        "paths to their .bed files)")
    p.add_argument("--out-dir", metavar="DIR", required=True,
                   help="Directory for the per-chromosome .L2/.M outputs "
                        "(named <prefix-basename>.L2)")
    _window_args(p, long_help=False)
    p.add_argument("--extra", action="store_true",
                   help="Include MAF WSA WSD WSDE RSTD columns")
    p.add_argument("--streaming", action=flag, default=None,
                   help="Force the out-of-core engine on/off (default: "
                        "auto)")
    p.add_argument("--chunk-rows", metavar="R", type=int, default=8192)
    p.add_argument("--n-devices", metavar="N", type=int, default=None,
                   help="Devices per chromosome run (default: all local)")
    p.add_argument("--shard-axis", choices=SHARD_AXES, default="snp",
                   help="Per-chromosome multi-device axis (see `ld`); "
                        "chromosomes still round-robin over hosts")
    p.add_argument("--annot", metavar="FILE", default=None,
                   help="Per-SNP annotation file for PARTITIONED LD "
                        "(matched to each bfile by SNP id; genome-wide "
                        "files work — SNPs absent from a chromosome "
                        "contribute zero rows)")
    p.add_argument("--resume-dir", metavar="DIR", default=None,
                   help="Checkpoint root for chunk-granular resume: each "
                        "chromosome checkpoints into "
                        "<DIR>/<bfile-basename>/ (streaming engine)")
    p.add_argument("--bucket-shapes", action=flag, default=True,
                   help="Pad each chromosome's compiled shape to a shared "
                        "bucket so a genome reuses ~4 compiled programs "
                        "instead of one per chromosome size (<=33%% padded "
                        "compute; outputs identical). Default on")

    p = command("h2", est_h2,
                "Estimate additive and non-additive heritability")
    p.add_argument("--sumstats", metavar="FILE", required=True,
                   help="Path to the GWAS sumstats file")
    p.add_argument("--ref-ld", metavar="PTH", required=True,
                   help="File/path with LD Scores used as regression "
                        "predictors")
    p.add_argument("--w-ld", metavar="PTH", required=True,
                   help="LD Scores for regression weights (may differ from "
                        "--ref-ld, e.g. scores restricted to regression "
                        "SNPs — the reference requires them equal)")
    p.add_argument("--strategy", choices=["one-stg", "two-stg"],
                   default="two-stg", help="Heritability estimation method")
    p.add_argument("--chisq-max", metavar="F", type=float, default=None,
                   help="Drop SNPs with chi-square above this "
                        "(default: max(1e-3*N_max, 80))")
    p.add_argument("--n-blocks", metavar="N", type=int, default=200,
                   help="Number of jackknife blocks")
    p.add_argument("--intercept-h2", metavar="F", type=float, default=None,
                   help="Constrain the additive LD-score regression "
                        "intercept")
    p.add_argument("--two-step", metavar="F", type=float, default=None,
                   help="Two-step estimator chi-square cutoff (default: 30 "
                        "when the intercept is free, disabled with "
                        "--intercept-h2)")
    p.add_argument("--use-M", dest="use_m", action="store_true",
                   help="Use .M file instead of .M_5_50")
    p.add_argument("--partitioned", action="store_true",
                   help="Partitioned (multi-annotation) h2: --ref-ld "
                        "columns other than CHR/SNP/BP are per-annotation "
                        "LD scores (with per-annotation .M/.M_5_50 "
                        "sidecars); --w-ld may differ from --ref-ld")
    p.add_argument("--on-device", action="store_true",
                   help="Run the regression in f32 on the accelerator "
                        "(compensated jackknife accumulation) instead of "
                        "the default f64 on the host CPU; with "
                        "--partitioned the solves use the unrolled "
                        "decomposition-free Cholesky, p <= 31 annotations")
    p.add_argument("--samp-prev", metavar="P", type=float, default=None,
                   help="Sample prevalence (with --pop-prev: report "
                        "liability-scale h2)")
    p.add_argument("--pop-prev", metavar="K", type=float, default=None,
                   help="Population prevalence")
    p.add_argument("-s", "--save-to-json", metavar="W", default=None,
                   help="Path to file where to write results")

    p = command("convert", convert,
                "Convert LD scores between nldsc-jax .L2 and original "
                "ldsc .l2.ldscore.gz formats (the reference's "
                "never-written ld_converter)")
    p.add_argument("--to-ldsc", metavar="OUT_PREFIX", default=None,
                   help="Write ldsc-format files at this prefix")
    p.add_argument("--from-ldsc", metavar="PREFIX", default=None,
                   help="Read ldsc-format files from this prefix")
    p.add_argument("-i", "--input", metavar="FILE", default=None,
                   help="Input .L2 file (with --to-ldsc)")
    p.add_argument("-o", "--out", metavar="FILE", default=None,
                   help="Output .L2 file (with --from-ldsc)")
    return parser


def main(argv: list[str] | None = None) -> int:
    """Run one command; returns the exit code (1 after a crash, whose
    cause is logged as ``[C] ... crashed with <Type>``)."""
    args = build_parser().parse_args(argv)
    print(__header__)
    if args.log_file:
        enable_file_logging()
    try:
        args.func(args)
    except Exception as ex:
        log.critical(
            "The program crashed with %s, what: %s\n"
            "Use `--display` flag for traceback",
            ex.__class__.__name__, ex, exc_info=args.display)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
