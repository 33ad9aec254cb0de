"""Hopper kernel budget checker — the port of ``repro.analysis.kernel_budget``.

The reference sums worst-case VMEM residency of each Pallas program against
a TPU core's budget.  The port's kernels are CUDA C++ for the H100, whose
limits are others (the ``hopper-kernels`` guide): 227 KB (232,448 B) of
dynamic shared memory a block, 65,536 registers an SM, at most 255 a
thread.  The shared memory of every launch is already computed by the
plans that mirror the CUDA sources (``kernels.mpo_linear._mma_plan`` /
``_narrow_plan`` / ``_bwd_plan``, ``kernels.ssd_scan._ssd_plan`` /
``_ssd_bwd_plan``, ``kernels.decode_attention._flash_plan``); this module
walks a config's MPO core shapes, SSD geometry and serving attention
geometry through them:

``kernel/smem-budget``     every plan the eligibility gate admits, at every
                           row tile the autotuner races
                           (``autotune.TILES``), must fit ``SMEM_LIMIT``
                           (forward, dL/dx over the i/j-swapped cores, the
                           cores backward; the SSD scan and its backward;
                           flash decode).  ``eligible_fn`` is injectable so
                           a test can seed a gate that admits an
                           over-budget tile.
``kernel/tile-alignment``  tripwires on the tile constants: the row tiles
                           the plans use (``MMA_BM``, ``NARROW_BM``) are the
                           autotuner's ``TILES``, every tile is a multiple
                           of ``TILE_ALIGN``, and the tiles each ``.cu``
                           dispatches on (read from its text) are the same
                           set.
``kernel/page-bounds``     flash decode's page reads, computed in Python as
                           ``csrc/decode_attention.cu``'s split kernel does
                           for each split block of ``_flash_plan``, at the
                           reference's corner cases (unmapped ``-1`` pages,
                           an identity table, the last page; lengths 0, 1,
                           a page and full): every read in the pool, and no
                           unmapped entry read below the slot's length.
``kernel/registers``       on the card, on request (``lint_registers``):
                           each built library's ``-Xptxas -v`` report —
                           registers x the block's threads above 65,536 is
                           an error, a spill store a warning, blocks an SM
                           info.  It reads the logs ``kernels._build``
                           keeps and never starts a build; where no log
                           exists it reports nothing.
"""

from __future__ import annotations

import re

from repro_torch.analysis.findings import Finding
from repro_torch.kernels import _build, autotune
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import mpo_linear as MK
from repro_torch.kernels import ssd_scan as SSD

MPO_FILE = "src/repro_torch/kernels/mpo_linear.py"
SSD_FILE = "src/repro_torch/kernels/ssd_scan.py"
DA_FILE = "src/repro_torch/kernels/decode_attention.py"

SMEM_LIMIT = MK.SMEM_LIMIT        # 227 KB: dynamic shared memory one block may use
SM_REGISTERS = 65536              # 32-bit registers an SM (and the most a block may hold)
MAX_THREAD_REGISTERS = 255
SM_THREADS, SM_BLOCKS = 2048, 32  # resident threads and blocks an SM
REG_GRANULE = 8                   # registers a thread are allocated in warps of 256

# the rows a plan is evaluated at: a decode step's, one row tile, a prefill
# or training batch's (``_narrow_plan``'s L groups and resident stages
# depend on them)
LINT_ROWS = (16, 128, 2048)
# the batches flash decode and the SSD scan are planned at (their splits and
# head groups depend on them)
LINT_SLOTS = (1, 8, 64)
LINT_SSD_BATCHES = (1, 8)
# the paged pool flash decode is linted at (the reference's): page size, pages a slot
LINT_PAGE_SIZE, LINT_MAX_PAGES = 16, 16


def _kib(b: int) -> str:
    return f"{b / 1024:.1f} KiB"


def default_eligible(shapes, bm: int, *, dtype: str, m: int) -> bool:
    """The engine's gate for a launch: ``kernel_eligible`` admits the core
    shapes and the route's plan exists at row tile ``bm`` and ``m`` rows."""
    return MK.kernel_eligible(shapes, dtype=dtype) and \
        MK.forward_plan(shapes, m, dtype, bm) is not None


def forward_smem(shapes, dtype: str, bm: int, m: int) -> int:
    """Shared memory of the forward ``forward_kernel`` names for these
    shapes at row tile ``bm`` and ``m`` rows: its plan's, or where the plan
    refuses the tile, what the CUDA source would ask for at the route's
    bond (one stage of W, the least ``csrc/mpo_linear.cu`` takes)."""
    plan = MK.forward_plan(shapes, m, dtype, bm)
    if plan is not None:
        return plan.smem
    shapes = tuple(tuple(int(d) for d in s) for s in shapes)
    route = MK.forward_kernel(shapes, dtype)
    if route == "mma":
        s = MK._mma_split(shapes, dtype)
        return MK._mma_smem_bytes(MK._mma_geometry(shapes, s, dtype), bm, dtype)
    if route == "cuda_core":
        s = MK._narrow_split(shapes)
        return MK._narrow_smem_bytes(MK._narrow_geometry(shapes, s), bm)
    return 0


def lint_mpo_call(shapes, *, dtype: str = "bfloat16", config: str = "",
                  budget: int = SMEM_LIMIT, eligible_fn=None) -> list:
    """Shared-memory findings for one MPO matrix (one core shape set) in
    the launches the engine can run for it: the forward, dL/dx (the forward
    over the i/j-swapped cores) and the cores backward.

    The invariant: a launch the gate admits, at any row tile the autotuner
    races, fits ``budget``.  The plans refuse a tile that does not fit, so a
    finding means the gate and the plans' shared memory have diverged."""
    eligible_fn = eligible_fn or default_eligible
    shapes = tuple(tuple(int(d) for d in s) for s in shapes)
    loc = "x".join(str(d) for s in shapes for d in s)
    swapped = tuple((d0, j, i, d1) for d0, i, j, d1 in shapes)
    train = MK.kernel_eligible(shapes, dtype=dtype, train=True)
    findings = []
    admitted = False
    for label, shp in (("fwd", shapes), ("dx", swapped)):
        if label == "dx" and not train:
            continue
        route = MK.forward_kernel(shp, dtype)
        if route is None:
            continue
        for bm in autotune.TILES[route]:
            for m in LINT_ROWS:
                if not eligible_fn(shp, bm, dtype=dtype, m=m):
                    continue
                admitted = True
                used = forward_smem(shp, dtype, bm, m)
                if used > budget:
                    findings.append(Finding(
                        check="kernel/smem-budget", severity="error", file=MPO_FILE,
                        location=f"{loc}:{label}:{route}@block_m={bm},m={m}",
                        message=f"the gate admits this launch but its shared memory "
                                f"{_kib(used)} exceeds the {_kib(budget)} a block may use "
                                f"— the launch would fail on the card", config=config))
                    break
    if train:
        plan = MK._bwd_plan(shapes, dtype)
        if plan is not None and plan.smem > budget:
            findings.append(Finding(
                check="kernel/smem-budget", severity="error", file=MPO_FILE,
                location=f"{loc}:dcores",
                message=f"the cores backward's tile pass takes {_kib(plan.smem)} of shared "
                        f"memory, above the {_kib(budget)} a block may use", config=config))
    if not admitted:
        findings.append(Finding(
            check="kernel/smem-budget", severity="info", file=MPO_FILE, location=loc,
            message=f"no {dtype} Hopper kernel takes these core shapes at any tile — the "
                    f"engine plans this matrix factorized or reconstructed", config=config))
    return findings


def lint_ssd_call(heads: int, head_dim: int, state: int, chunk: int, *, dtype: str,
                  config: str = "", budget: int = SMEM_LIMIT) -> list:
    """Shared-memory findings for the SSD scan and its backward at one
    geometry (H heads of P, state N, chunk q), over a few batches and
    sequence lengths (the head group depends on them)."""
    loc = f"H={heads},P={head_dim},N={state},q={chunk}"
    if chunk > SSD.QMAX or state > SSD.NMAX or head_dim > SSD.PMAX:
        return [Finding(check="kernel/smem-budget", severity="error", file=SSD_FILE,
                        location=loc,
                        message=f"outside the kernel's caps (chunk <= {SSD.QMAX}, N <= "
                                f"{SSD.NMAX}, P <= {SSD.PMAX}), which its shared memory "
                                f"is sized for", config=config)]
    findings = []
    for b in LINT_SSD_BATCHES:
        for s in (chunk, 8 * chunk):
            plans = [("fwd", lambda: SSD._ssd_plan(b, s, heads, head_dim, state, chunk, dtype)),
                     ("bwd", lambda: SSD._ssd_bwd_plan(b, s, heads, head_dim, state, chunk,
                                                       dtype))]
            for label, make in plans:
                try:
                    used = max(make().smem)
                except ValueError:       # no head group fits
                    used = budget + 1
                if used > budget:
                    findings.append(Finding(
                        check="kernel/smem-budget", severity="error", file=SSD_FILE,
                        location=f"{loc}:{label}@B={b},S={s}",
                        message=f"a launch of the SSD scan's {label} takes {_kib(used)} of "
                                f"shared memory, above the {_kib(budget)} a block may use",
                        config=config))
    return findings


def flash_page_reads(length: int, table, ps: int, mp: int, pool: int, splits: int) -> list:
    """The pages one slot's split blocks read, as ``split_kernel`` in
    ``csrc/decode_attention.cu`` computes them: split s of S owns the
    slot's pages [floor(s np / S), floor((s + 1) np / S)), np =
    min(ceil(length / ps), MP); an entry is clamped into the pool (an
    unmapped -1 reads page 0).  Returns ``[(split, logical page, table
    entry, physical page), ...]``."""
    np_ = min((max(length, 0) + ps - 1) // ps, mp)
    out = []
    for s in range(splits):
        for page in range(s * np_ // splits, (s + 1) * np_ // splits):
            entry = int(table[page]) if 0 <= page < len(table) else -1
            out.append((s, page, entry, min(max(entry, 0), pool - 1)))
    return out


def _page_tables(mp: int, pool: int, length: int, ps: int) -> dict:
    """The corner-case tables of one slot: the pages its length covers
    mapped and the rest unmapped (-1), every page mapped in order, and every
    page on the pool's last; a slot of length 0 also with every entry -1."""
    used = min(-(-max(length, 0) // ps), mp)
    tables = {"unmapped-tail": [p if p < used else -1 for p in range(mp)],
              "identity": list(range(mp)),
              "last-page": [pool - 1] * mp}
    if length == 0:
        tables["unmapped"] = [-1] * mp
    return tables


def lint_decode_attention_call(num_kv_heads: int, group: int, head_dim: int,
                               page_size: int, max_pages: int, *, dtype: str = "bfloat16",
                               config: str = "", budget: int = SMEM_LIMIT,
                               reads_fn=None) -> list:
    """Shared-memory, alignment and page-bounds findings for one flash
    decode geometry.  ``reads_fn`` (default ``flash_page_reads``) is
    injectable so a test can seed a read past the pool."""
    reads_fn = reads_fn or flash_page_reads
    loc = f"kv={num_kv_heads},g={group},dh={head_dim},ps={page_size},mp={max_pages}"
    esize = 2 if dtype == "bfloat16" else 4
    findings = []
    if group * head_dim > DA.THREADS * DA.MAXR:
        findings.append(Finding(
            check="kernel/smem-budget", severity="error", file=DA_FILE, location=loc,
            message=f"G * Dh = {group * head_dim} exceeds the {DA.THREADS * DA.MAXR} "
                    f"accumulator values a block holds in registers", config=config))
    pool = max(max_pages, 1)        # worst case: one slot owns every page
    for b in LINT_SLOTS:
        plan = DA._flash_plan(b, num_kv_heads, group, head_dim, page_size, max_pages)
        used = DA._flash_smem(group, head_dim, plan.kt, esize)
        if used > budget:
            findings.append(Finding(
                check="kernel/smem-budget", severity="error", file=DA_FILE,
                location=f"{loc}@B={b}",
                message=f"split_kernel's shared memory {_kib(used)} (kt={plan.kt}) exceeds "
                        f"the {_kib(budget)} a block may use", config=config))
        for length in sorted({0, 1, page_size, page_size * max_pages}):
            for tname, table in _page_tables(max_pages, pool, length, page_size).items():
                for split, page, entry, phys in reads_fn(length, table, page_size, max_pages,
                                                         pool, plan.splits):
                    where = (f"{loc}:split {split}/{plan.splits},page {page},len={length},"
                             f"table={tname}")
                    if not 0 <= page < max_pages or not 0 <= phys < pool:
                        findings.append(Finding(
                            check="kernel/page-bounds", severity="error", file=DA_FILE,
                            location=where,
                            message=f"reads logical page {page} -> physical page {phys}, "
                                    f"outside the table [0, {max_pages}) or the pool "
                                    f"[0, {pool}) — an out-of-bounds read", config=config))
                    elif entry < 0 and page * page_size < length:
                        findings.append(Finding(
                            check="kernel/page-bounds", severity="error", file=DA_FILE,
                            location=where,
                            message=f"reads an unmapped (-1) entry below the slot's length "
                                    f"{length}: keys the slot holds come from page 0",
                            config=config))
    if head_dim * esize % 16:
        findings.append(Finding(
            check="kernel/tile-alignment", severity="info", file=DA_FILE, location=loc,
            message=f"a key row of {head_dim} {dtype} values is not whole 16-byte chunks: "
                    f"split_kernel stages it element by element (correct, slower)",
            config=config))
    return findings


# ---- tile constants ----

# the row tiles each forward source dispatches on, read from its text
_DISPATCH = {"mma": ("mpo_linear_mma.cu", re.compile(r"launch_tc<T, (\d+)>")),
             "cuda_core": ("mpo_linear.cu", re.compile(r"launch_main<(\d+)>"))}


def dispatched_tiles(route: str) -> set:
    """The row tiles ``route``'s CUDA source dispatches on."""
    name, pat = _DISPATCH[route]
    return {int(v) for v in pat.findall((_build.CSRC / name).read_text())}


def lint_constants(*, mma_bm=None, dispatched=None) -> list:
    """Config-independent tripwires on the tile constants (``mma_bm``: the
    tensor-core plans' row tiles, ``dispatched``: ``{route: tiles}`` the
    sources dispatch on; each defaults to the live one, tests seed a bad
    one)."""
    tiles, align = autotune.TILES, autotune.TILE_ALIGN
    planned = {"mma": MK.MMA_BM if mma_bm is None else mma_bm, "cuda_core": MK.NARROW_BM}
    findings = []

    def add(location, message):
        findings.append(Finding(check="kernel/tile-alignment", severity="error",
                                file=MPO_FILE, location=location, message=message))

    for route, bms in planned.items():
        if tuple(tiles.get(route, ())) != tuple(bms):
            add(f"TILES[{route!r}]", f"the autotuner races {tuple(tiles.get(route, ()))} but "
                f"the {route} plans take {tuple(bms)}")
        for bm in bms:
            if bm % align:
                add(f"{route}@block_m={bm}", f"row tile {bm} is not a multiple of "
                    f"TILE_ALIGN={align} (one tensor-core fragment's rows)")
        built = dispatched_tiles(route) if dispatched is None else set(dispatched[route])
        if built != set(bms):
            add(f"{_DISPATCH[route][0]}:dispatch", f"the source dispatches on row tiles "
                f"{sorted(built)}, the plans use {sorted(bms)}")
    return findings


def core_shape_sets(shapes_tree) -> set:
    """Distinct MPO core shape tuples in a params tree (the trailing 4 legs
    of each core: leading stacked dims are layers / experts, not tiles)."""
    from repro_torch.core import layers
    out = set()

    def visit(node):
        if isinstance(node, dict):
            if "cores" in node:
                cores = layers.cores_to_list(node["cores"])
                out.add(tuple(tuple(int(d) for d in c.shape[-4:]) for c in cores))
                return
            for v in node.values():
                visit(v)

    visit(shapes_tree)
    return out


def lint_kernels(cfg, *, shapes_tree=None, budget: int = SMEM_LIMIT) -> list:
    """Every kernel-budget finding for one config (``shapes_tree``: a
    session's live parameters, else the abstract init's)."""
    from repro_torch.analysis.sharding_lint import abstract_params
    if shapes_tree is None:
        shapes_tree, _ = abstract_params(cfg)
    findings = list(lint_constants())
    for shapes in sorted(core_shape_sets(shapes_tree)):
        findings += lint_mpo_call(shapes, dtype=cfg.dtype, config=cfg.name, budget=budget)
    if cfg.family in ("ssm", "hybrid"):
        findings += lint_ssd_call(cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                                  cfg.ssm_chunk, dtype=cfg.dtype, config=cfg.name,
                                  budget=budget)
    # paged serving (the flash kernel) is the transformer families' only:
    # the others' caches have no per-slot KV pages
    if cfg.family in ("dense", "moe", "vlm"):
        group = max(cfg.num_heads // max(cfg.num_kv_heads, 1), 1)
        findings += lint_decode_attention_call(cfg.num_kv_heads, group, cfg.head_dim,
                                               LINT_PAGE_SIZE, LINT_MAX_PAGES,
                                               dtype=cfg.dtype, config=cfg.name,
                                               budget=budget)
    return findings


# ---- registers, from the compiler's report ----

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_BOUNDS = re.compile(r"__launch_bounds__\(\s*([^,)]+?)\s*(?:,[^)]*)?\)\s*(\w+)\s*\(", re.S)
_CONST = re.compile(r"constexpr int (\w+) = (\d+);")
# block sizes a constant does not name: mma_kernel runs 8 more warps to form
# L at BM = 128 (``kSplitWarps<BM>``, csrc/mpo_linear_mma.cu)
TEMPLATE_THREADS = {
    "mma_kernel": lambda consts, ints: consts["THREADS"] * (2 if ints and ints[0] >= 128
                                                            else 1),
}


def demangle(mangled: str) -> tuple[str, list]:
    """(kernel name, its template's arguments: a leading type's name, then
    the integers) of an Itanium-mangled entry point
    (``_ZN12_GLOBAL__N_110mma_kernelIfLi128ELi4EEEv...`` ->
    ``("mma_kernel", ["float", 128, 4])``)."""
    if not mangled.startswith("_Z"):
        return mangled, []
    i = 2
    nested = mangled[i:i + 1] == "N"
    i += nested
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
        if not nested:
            break
    if mangled[i:i + 1] != "I":
        return name, []
    targs = [int(v) for v in re.findall(r"L[ib](\d+)E", mangled[i:])]
    m = re.match(r"I(?:(f)|(d)|(\d+))", mangled[i:])
    if m and m.group(3):
        n = int(m.group(3))
        j = i + 1 + len(m.group(3))
        targs.insert(0, mangled[j:j + n])
    elif m:
        targs.insert(0, "float" if m.group(1) else "double")
    return name, targs


def parse_ptxas(log: str) -> dict:
    """``{mangled entry: {"registers": r, "spill_stores": b, "spill_loads":
    b}}`` from ``nvcc -Xptxas -v`` output."""
    out, entry, props = {}, None, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            entry, props = m.group(1), None
            out.setdefault(entry, {"registers": 0, "spill_stores": 0, "spill_loads": 0})
            continue
        m = _PROPS.search(line)
        if m:
            props = m.group(1)
            continue
        m = _SPILL.search(line)
        if m and entry is not None and props == entry:
            out[entry]["spill_stores"] = int(m.group(1))
            out[entry]["spill_loads"] = int(m.group(2))
            continue
        m = _REGS.search(line)
        if m and entry is not None:
            out[entry]["registers"] = int(m.group(1))
    return out


def block_threads(source: str) -> dict:
    """``{kernel name: threads, or fn(template ints) -> threads}`` from a
    CUDA source's ``__launch_bounds__`` (its first argument, a named
    constant, or ``TEMPLATE_THREADS`` for a template-dependent one)."""
    consts = {k: int(v) for k, v in _CONST.findall(source)}
    out = {}
    for expr, name in _BOUNDS.findall(source):
        if expr.isdigit():
            out[name] = int(expr)
        elif expr in consts:
            out[name] = consts[expr]
        elif name in TEMPLATE_THREADS:
            out[name] = lambda ints, f=TEMPLATE_THREADS[name]: f(consts, ints)
    return out


def register_findings(lib: str, log: str, source: str) -> list:
    """The ``kernel/registers`` findings of one library's compiler report."""
    threads = block_threads(source)
    file = f"src/repro_torch/csrc/{lib}.cu"
    findings = []
    for mangled, rec in sorted(parse_ptxas(log).items()):
        name, targs = demangle(mangled)
        loc = f"{lib}:{name}" + (f"<{','.join(map(str, targs))}>" if targs else "")
        t = threads.get(name)
        t = t([a for a in targs if isinstance(a, int)]) if callable(t) else t
        regs = rec["registers"]
        if t is None:
            findings.append(Finding(
                check="kernel/registers", severity="warning", file=file, location=loc,
                message=f"{regs} registers a thread; no __launch_bounds__ names this "
                        f"kernel's block size", config=""))
            continue
        alloc = -(-max(regs, 1) // REG_GRANULE) * REG_GRANULE
        if regs > MAX_THREAD_REGISTERS or alloc * t > SM_REGISTERS:
            findings.append(Finding(
                check="kernel/registers", severity="error", file=file, location=loc,
                message=f"{regs} registers a thread x {t} threads = {alloc * t} exceeds the "
                        f"{SM_REGISTERS} an SM holds: the launch fails"))
        if rec["spill_stores"]:
            findings.append(Finding(
                check="kernel/registers", severity="warning", file=file, location=loc,
                message=f"{rec['spill_stores']} bytes of spill stores ("
                        f"{rec['spill_loads']} of loads) at {regs} registers a thread"))
        blocks = min(SM_REGISTERS // (alloc * t), SM_THREADS // t, SM_BLOCKS)
        findings.append(Finding(
            check="kernel/registers", severity="info", file=file, location=loc,
            message=f"{regs} registers x {t} threads, {rec['spill_stores']} B spill stores: "
                    f"{blocks} block(s) an SM by registers"))
    return findings


def lint_registers(libs=None) -> list:
    """``kernel/registers`` over the built libraries (default: every
    source), from the ``-Xptxas -v`` report ``kernels._build`` keeps beside
    each.  Never builds; a library without a log reports nothing."""
    findings = []
    for lib in _build.sources() if libs is None else libs:
        try:
            log = _build.build_log(lib)
        except OSError:
            continue
        findings += register_findings(lib, log, (_build.CSRC / f"{lib}.cu").read_text())
    return findings
