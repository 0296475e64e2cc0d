#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flink_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--records N] [--revenue-records N]
        [--session-records N] [--join-records N] [--q7-records N]
        [--cep-records N]

Phases, each fatal on failure (no result line is printed then):

1. build both kernels from the checkout with nvcc, one process each, in
   parallel: the exchange rank (flink_tpu_torch/csrc/rank.cu) and the
   ordered fold (flink_tpu_torch/csrc/ordered_fold.cu);
2. hold the rank kernel bit-identical to its plain PyTorch versions on the
   card (rank_plain, exchange_rank_flat_plain) over 20 random shapes (D
   1..64, R 1..8, C up to 1<<20, with negative and out-of-range lanes and
   ranks past the bucket width), one launch per call;
3. time the flat rank at the shapes Nexmark Q5 gives it (R=8 shards,
   C=131072 lanes, D=8): per wrapper call by CUDA events, per launch by
   torch.profiler, beside its plain version and its memory bound (12 B per
   lane at 3.35 TB/s);
4. run the exchange+scatter step on the card and on the CPU over Q5's
   first 1<<20 bids (P=8, cap=1<<16, one slot per (auction, slice) as the
   engine stages them) for Count, float32 Sum over values with NaN
   payloads and +inf/-inf lanes (so that the CPU's NaN bits are checked),
   and float32 Max/Min with NaN payloads (signalling, quiet, negative),
   +0.0 and -0.0 in shared slots: every plane equal bit for bit; then fire the Sum plane (its NaN payloads
   and infinities included) over windows of 5 slices, Q5-revenue's, on the
   card and on the CPU: every merged sum equal bit for bit. Then (4b)
   hold the ordered fold's grouping
   (group_planes) against a stable sort on the CPU and its fold against
   its plain version on the CPU, bit for bit, at four shapes: the fold's
   shapes in that step (Q5's keys), Zipf(1.1) over 100k keys in float32
   and in float64 (one plane of 100001 slots, three radix passes, long
   runs), and the step's shapes with planes of 1<<17 slots (three
   passes); time each (wrapper call, device us per stage, the plain
   version, torch.sort(stable=True) alone on the int64 flat targets, and
   index_add_), beside the bytes bound and the dependent-add chain bound
   at the card's top SM clock; hold the fold's max/min modes on the card
   against their plain version on the CPU over the NaN-payload lanes
   (0 slots differing) and time them; and compare torch's own
   scatter_reduce_ amax/amin on the card with the CPU (recorded, not
   gated);
5. run Nexmark Q5 through the public API at parallelism.default=8 (100k
   auctions, 100k events/s of event time, 10 s / 2 s HOP, top-k 16,
   micro-batches of 1<<20 records) and check every fired window's winners
   against a NumPy oracle computed here;
6. run "Q5-revenue" the same way — the same bids, keyed by auction, HOP
   10 s / 2 s, ``.sum("price")`` in float32, 10M bids — and check EVERY
   fired (window, auction) sum bit for bit against a NumPy oracle that
   sums each slice in stream order (np.add.at) and folds each window's
   five slices left to right, as the engine merges them;
7. run Q5 as phase 5 at parallelism.default=1 with bench.py's settings
   (the single-device slot table: capacity 1<<22, the slot layout,
   dispatch-ahead 8, micro-batches of 1<<20, 40M bids): every window's
   winners against the oracle, and the number of windows with more tied
   winners than k (the device top-k decides which of those survive);
8. run Q5-revenue as phase 6 at parallelism 1 (10M bids): every fired sum
   equal to the oracle; then time one call of the ordered fold at that
   engine's shape — one plane of 1<<22 slots, 1<<20 lanes of Q5's first
   bids — against its plain version and its bytes bound;
9. a forced-eviction run: a float32 Sum over Q5's first 3M bids with the
   values of phase 4 (NaN payloads, +inf and -inf), HOP 10 s / 2 s, on the
   single-device engine with a device budget of 1<<17 slots (far below
   its live rows, so slices spill to the host and reload), on the card
   and on the CPU: every fired batch equal bit for bit, and the spill
   counters equal;
10. run Q5 as phase 7 in the pane layout (state.window-layout=panes,
    latency.pane-preagg on: the delta fire), 40M bids: every window's
    winners against the oracle; print the ring's rows R and the pane
    state's bytes on the card;
11. run Q5-revenue in the pane layout: over the first 2M bids the card's
    sink rows equal, in order and bit for bit, the same job through the
    port on the CPU; over 10M bids every (window, auction) with bids fires
    once and no other, and every sum is within 2 (n - 1) 2^-24 of the
    stream-order oracle's relative to it (n: the row's bids; prices are
    positive, so that bounds any two orders of the adds: pre-aggregation
    folds a window's partial in record order, not slice by slice); then
    time one call of the ordered fold at the run's [1, R*C] shape with the
    lanes of its largest combined scatter, against its plain version;
12. run BASELINE row 5 through the public API at parallelism 1 (sessions
    with a 2 s gap over DataGenSource's records and 10M keys, float32
    ``.sum("value")``, micro-batches of 1<<16, a 1<<19-row device budget:
    the paged spill tier evicts and reloads), cut from the row's 12M
    records to 8M when phase 25 came and to 4M when phase 27 came (the
    script's time): (a) the sessions'
    (key, start, end) multiset equals a NumPy oracle's exactly and every
    sum is within 2 (n - 1) 2^-24 of its stream-order float32 sum; 0 late
    records; the native session plane ran; print events/s, fire latency,
    the spill counters and the state's bytes on the card; (b) the same job
    over the first 2M records on the card and on the CPU: rows equal in
    order, bit for bit, spill counters equal; (c) a float32 Max over phase
    4's NaN payloads and signed zeros, 1M records over 100k keys with
    timestamps moved back by up to 3 s so that sessions merge, under a
    1<<15-row budget, card == CPU likewise; (d) one flat_merge_pairs call
    at row 5's [1<<19] table with the lanes of (c)'s largest merge group
    (row 5's own stream, in order, merges nothing), and one ordered fold
    at row 5's ingest shape ([1, 1<<19], the lanes of the last full
    batch that (b)'s card run folded, equal bit for bit to its plain version on
    the CPU):
    for each, wrapper and device ms, its plain version, its bytes bound
    (real lanes only: padded lanes are the program's own).

13. run BASELINE row 5 on the mesh session engine at parallelism 8: (a)
    the reference's mesh-sessions shape (``tools/bench_mesh_sessions.py``
    as ``tools/bench_suite.py:247-265`` runs it: 4M records, keys uniform
    over 10M from ``default_rng(3)``, 400k events/s of event time, batches
    of 1<<16, float32 Sum of ones, gap 2,000 ms, 1<<16 rows a shard, a
    25 ms fire deadline) through ``flink_tpu_torch/benchmarks/
    mesh_sessions.py``: every fired (key, start, end, sum) equal to a
    NumPy oracle that places each ingest split's watermark; rows evicted
    and reloaded both > 0; events/s, fire p50/p99, the spill counters and
    the page-rewrite amplification printed; (b) row 5's job
    (``DataGenSource``) at ``parallelism.default: 8`` through
    ``env.execute()`` over its first 2M records under 1<<16 rows a shard,
    on the card and on the CPU: rows equal in order, bit for bit, spill
    counters equal; (c) phase 12(c)'s out-of-order float32 Max job at P=8
    under 1<<12 rows a shard, card == CPU likewise, with merge groups,
    evictions and ordered-fold launches inside the merges; (d) the mesh
    merge step alone at (c)'s largest group, float32 Sum and Max: card ==
    CPU, wrapper ms, device ms (torch.profiler), its plain version's ms and
    the bytes bound (16 B a real pair, 8 B a destination, 3.35 TB/s).
14. checkpoints and restore: (a) Q5 at P=8 through ``env.execute()`` at
    phase 5's size (40M bids, micro-batches of 1<<20) with
    ``state.checkpoints.dir`` in a temporary directory, a checkpoint every
    8 source batches, incremental with a full one every 2nd: a map in
    front of the keyBy raises after ~60 % of the stream; a fresh
    environment with the same graph (a benign map of the same name)
    restores from the root with ``restore_from=`` and runs to the end; the
    union of both sinks equals phase 5's oracle in every window, and the
    rank kernel launched in both runs (Count has no float leaf: no
    ordered fold); (b) the mesh session engine at phase 13(a)'s shape
    (2M of its 4M records — the script's time —, batches of 1<<16, 1<<16
    rows a shard, dispatch-ahead 2,
    async fires, each batch's watermark its last timestamp: the deadline
    split off) through the port's ``run_crash_restore_verify`` with
    ``tools/chaos_smoke.py``'s fault plan spread over the run (a
    dispatch-fence crash, a page reload broken past its retries, a
    post-dispatch exchange crash, a torn checkpoint) and the port's
    ``SessionWindower`` on the card as the oracle: no divergence, 3
    crashes and 3 restores, at least one corrupt checkpoint skipped, every
    planned point injected, every committed (key, start, end, sum) equal
    bit for bit to phase 13(a)'s NumPy oracle, the restores through the
    page tier, both kernels launched; (c) card == CPU for snapshots:
    Q5-revenue at P=1 in slots under a 1<<17-slot budget (3M bids),
    Q5-revenue in the pane layout (2M bids; the full-window harvest, since
    a restore refolds pre-aggregated partials slice by slice, which moves
    float sums by an ulp against an uninterrupted run's record-order
    partials), row 5 at P=1 and row 5 at P=8
    (their first 500k records under 1<<18 rows and 1<<15 rows a shard, a
    checkpoint every 3 batches: cut from 1M records under 1<<19 and 1<<16
    when phase 19 came, to keep the script inside its time) run with
    checkpoints on the card and on the
    CPU: every checkpoint equal array by array, bit for bit; then the CPU
    restores the card's middle checkpoint and finishes, and every row it
    fires equals the card's; (d) on the card, a P=8 mesh-sessions
    snapshot (1M records of 13(a)'s stream) restores into the P=1
    ``SessionWindower`` mid-stream and a P=1 snapshot into the P=8
    engine: each finished run equals the uninterrupted one, bit for bit.
    ``python3 -c 'import torch, chip_smoke;
    chip_smoke.phase_checkpoints(torch)'`` runs phase 14 alone.
15. streaming joins: (a) the Q8 shape of ``tools/bench_joins.py``
    (100k sellers, band [0, 10 s], 200k events/s of event time per side,
    2M records — the bench's 4M, cut to keep the script's time — in
    batches of 1<<15 alternating sides, 1<<18 slots a shard
    a side, P=8) through ``flink_tpu_torch/benchmarks/joins.py`` on the
    card, then the same stream through the same engine with
    ``backend="host"``: every emitted batch equal in order, bit for bit
    (compared by a digest of each batch's names, dtypes and bytes);
    events/s, emit latency p50/p99 and matches printed; (b) the 10M-key
    shape (band +-2 s, 400k events/s, 1<<16 slots and device budget a
    shard a side) likewise, with rows evicted and cold rows served from
    the pages both > 0; (c) the interval engine (forced eviction) and the
    temporal engine at ``tools/join_smoke.py``'s shape on the card and on
    the CPU: every batch, every snapshot, the spill counters, the
    late-row count and every value plane outside slot 0 equal; (d)
    ``KeyedStream.interval_join().between()`` through ``env.execute``
    at ``parallelism.default=8`` with ``join.mode=device`` (two sources of 500k rows over 200k keys, band
    +-1 s, a checkpoint every 16 source batches): its rows equal
    ``join.mode=host``'s as a multiset, its batches and every checkpoint
    equal the CPU's; (e) Nexmark Q7 at BASELINE row 3's settings (10M
    bids, 2 s windows, micro-batches of 1<<16, capacity 1<<20, P=1):
    every window's (max_price, winners) equal to ``oracle_q7``, the max
    still float32; events/s and window-fire latency printed.
    ``python3 -c 'import torch, chip_smoke; chip_smoke.phase_joins(torch)'``
    runs phase 15 alone.
16. CEP: (a) the ``cep_patterns_10m_keys`` row of ``tools/bench_cep.py``
    (a 2-stage within-2 s sequence over 10M keys at 400k events/s of
    event time, 500k records — the bench's 4M, cut to 2M when phase 21
    came, to 1M when phase 24 came and to 500k when phase 27 came, to
    keep the script's time (500k still evicts and reloads, 250k does not)
    — in batches
    of 1<<15, P=8, 1<<14 slots a shard
    against ~260k live partials, spill to a temp dir) through
    ``flink_tpu_torch/benchmarks/cep.py`` on the card: its first 1<<17
    records (cut from 1<<19 when phase 23 came and from 1<<18 when phase
    26 came, to keep the script inside its time) equal, batch for batch (by digest), to the same engine with
    ``backend="host"``; every match of the 500k records equal, as a sorted
    multiset, to a NumPy oracle written here; rows evicted and reloaded
    > 0; one rank launch per ingest batch; events/s, emit latency p50/p99,
    the host backend's events/s, and the NFA advance per fire (calls,
    synchronised wall ms p50/p99, and on one fire's inputs captured
    mid-run its CUDA-event ms, device ms and device kernels per call,
    card == CPU on them); (b) ``tools/cep_smoke.py``'s shapes (P=8, 256
    slots a shard: the 3-stage within-50 sequence under both skips, the
    always-alive pattern over 20k keys with spill), the consecutive
    ``times(2, 3)`` loop and the two widest layouts (Q=29 with R=7 and
    R=29) on the card and the CPU: every batch, the spill counters,
    ``query_match_batch``, every plane outside slot 0 and the snapshot
    equal; (c) a snapshot of (a)'s engine mid-stream on the card restored
    into fresh engines on the card and on the CPU, both continuations
    equal to the uninterrupted run (snapshot bytes, restore ms); (d) a
    ``Transformation`` whose factory is ``MeshCepOperator`` through
    ``env.execute`` at ``parallelism.default=8`` with a checkpoint every
    2 source batches: rows equal, in order, to
    ``CEP.pattern(keyed, p).select()``'s (the host operator).
    ``python3 -c 'import torch, chip_smoke; chip_smoke.phase_cep(torch)'``
    runs phase 16 alone.
9(b), 17. the mesh window engine under a device budget, batch mode and
    BASELINE row 1 (run after phase 16): (9b) phase 9's stream (Q5's first
    3M bids in batches of 1<<18, phase 4's float32 specials, HOP 10 s /
    2 s) with each bid's event time moved back by up to 4 s (seeded) and
    each batch's watermark 4 s behind its newest bid, so slices already
    spilled are touched again, through ``MeshWindowEngine`` at P=8 under
    1<<14 rows a shard on the card and on the CPU: every fired batch and
    the spill counters equal bit for bit, rows evicted and reloaded > 0,
    at least one hybrid fire; (17a) Q5 at P=8 through ``env.execute()``
    over 10M bids (cut from phase 5's 40M: to 20M when phase 23 came, to
    10M when phase 24 came, to keep the script inside its time;
    micro-batches of 1<<20) under
    ``state.slot-table.max-device-slots`` 1<<16 a shard: every window's
    winners equal ``q5_oracle``, rows evicted > 0; events/s, fire p50/p99,
    the spill counters, hybrid fires and the state's bytes on the card
    printed; (17b) phase 13(c)'s out-of-order float32 Max job (its first
    250k records, batches of 1<<13, watermark 3 s behind) on
    ``MeshSessionEngine(spill_layout="namespaces")`` at P=8 under 1<<11
    rows a shard (1<<10 raises ``SlotTableFullError``: one batch's
    sessions are protected), card == CPU bit for bit, rows evicted > 0;
    (17c) ``flink_tpu_torch/benchmarks/wordcount.py`` at 200,000 lines on
    the card (P=1; ``.sum("one")`` keeps a float32 leaf, so the ordered
    fold launches), per-word totals equal to the oracle, words/s and fire
    latency printed; (17d) ROADMAP Queue C item 11's job in batch mode at
    P=8 on the card and the CPU: rows equal, key 0 window 0 = 44.0.
    ``python3 -c 'import torch, chip_smoke; chip_smoke.phase_slice11(torch)'``
    runs them alone (each also as ``phase_mesh_spill``,
    ``phase_mesh_budget_q5``, ``phase_mesh_sessions_ns``,
    ``phase_wordcount`` and ``phase_batch_mode``).
18. shard-granular failure domains (after phase 17): (18a) BASELINE row 7
    (``tools/bench_suite.py:332-370``, ``tools/chaos_smoke.py:40-125``) at
    its own size through ``flink_tpu_torch/benchmarks/shard_loss.py``:
    1,000,000 keys, 8 steps of 125,000 records, the session engine at P=4
    with 1<<14 rows a shard, ``device.lost`` at the 15th probe of shard 1,
    seed 7, a checkpoint every 2 steps, against ``SessionWindower``: no
    divergence, one shard lost, one unit restored, 0 < records replayed
    <= events/4, rows evicted > 0; the recovery ms and its parts, the
    survivors' rows moved, events/s and the launches before and after the
    loss printed; (18b) Q5-revenue at P=8 (6M bids in steps of 1<<20, cut
    from the benchmark's 10M when phase 27 came; HOP
    10 s / 2 s, float32 Sum of the price) through
    ``run_shard_loss_verify``, shard 3 lost at step 5's watermark (after
    the second checkpoint), against ``SliceSharedWindower``: the same
    gates with events/8 (no eviction gate: the engine has no budget), the
    rank kernel launched at D=8 before the loss and at D=7 after it, the
    ordered fold launched; (18c) card == CPU bit for bit (the committed
    windows, the report's signature, the final engine snapshot) for (a)
    at 60,000 keys and for (b)'s job over its first 1M bids (cut from 2M
    when phase 25 came) in steps of
    1<<18 with a live reshard 8 -> 5 -> 8 (``run_crash_restore_verify``'s
    ``rescales``) in place of the loss; (18d) Q5 at P=8 through
    ``env.execute()`` over 3M bids with ``watchdog.enabled``: the rows
    equal the job without it and sections were timed; with ``device.lost``
    armed, ``execute()`` raises ``ShardFailedError`` naming shard 5; (18e)
    the engines of 15(a) (the Q8 join shape, after 1<<19 records) and
    16(a) (the CEP row, after 8 batches) mid-run, on the card and on the
    CPU: every shard unit restored into a fresh engine with its key-group
    filter and merged equals the merge of the units, whose union is the
    snapshot; card == CPU. ``python3 -c 'import torch, chip_smoke;
    chip_smoke.phase_shard_loss(torch)'`` runs phase 18 alone.
19. process functions and durability (after phase 18): (19a) the
    ``CountWithTimeout`` job of Flink's Process Function documentation
    (``flink_tpu_torch/benchmarks/process_timeout.py``) over
    ``DataGenSource(2M records, 10M keys, 20k events/s of event time,
    seed 7)`` (cut from the job's 4M when phase 25 came) in batches of
    1<<16 at P=1, its count and lastModified in
    int64 ``DeviceValueState``s on the card (~3.30M keys, 1<<22 slots),
    each batch's states written with one put whose duplicate keys the
    newest lane wins: the card's rows equal the same job on the CPU and a
    NumPy oracle in emission order, and so does the async variant
    (``ctx.async_state``) — those two comparison runs over the first 1M
    records (cut from 4M when phase 23 came, to keep the script inside its
    time; the card's own run keeps all 4M against the oracle); events/s,
    fire p50/p99, timers registered and
    fired, and the host seconds of the timer heap and the state ops
    printed; (19b) the changelog backend (``checkpoint/changelog.py``) on
    the card over Q5-revenue's first 2M bids (float32 Sum of the price
    per auction and 2 s slice, batches of 1<<16, a checkpoint every 4, a
    materialization every 8, namespaces past the 10 s window freed): the
    newest checkpoint and one before the last materialization restored
    into fresh backends equal the live table at their cut and the CPU's,
    bit for bit; a checkpoint truncated past its offset is refused; the
    ordered fold launched; checkpoint, materialize and restore ms printed;
    (19c) phase 5's Q5 at P=8 over 10M bids into a ``BinaryFileSink``,
    stopped by a ``SavepointRequest(stop=True)`` served after batch 5
    (its source polled inline, without the pump thread, so that the
    request lands right after that batch) and resumed from the savepoint: both files read back through
    ``BinaryFileSource`` equal an uninterrupted run's windows (k of the
    tied winners where more than k tie, as phase 5), the drained stop
    fires every window up to the cut, and the rank kernel launched
    before the stop and after the resume; (19d)
    ``tools/bench_async_state.py``'s shape on a ``DeviceValueState``
    (2,000 rounds x 16 ops x 64 keys), sync and async, card == CPU, and
    200,000 puts into 1,000 slots equal to NumPy's ``a[s] = x`` on the
    card. ``python3 -c 'import torch, chip_smoke;
    chip_smoke.phase_process(torch)'`` runs phase 19 alone
    (``phase_process(torch, "cpu", small=True)`` rehearses it without a
    card).
20. SQL over Kafka and the retraction path (after phase 19): (20a)
    BASELINE row 4 as ``tools/bench_suite.py:136-190`` runs it: 8,000,000
    events into the port's ``FakeBroker`` (4 partitions, keys over 10,000
    and values from ``default_rng(1)``, 100,000 events/s of event time),
    ``CREATE TABLE ... WITH ('connector'='kafka', ...)`` and the HOP(2 s,
    10 s) ``SUM(value)`` query through ``StreamTableEnvironment`` at
    micro-batches of 1<<16, once warm and once measured
    (``execute_sql(...).collect()``): every (key, window) sum equal bit for
    bit to a NumPy oracle that folds each slice in the source's arrival
    order in float32 (SQL ``SUM`` folds a float32 leaf) and each window's
    five slices left to right, events/s and fire p50/p99 printed; the card
    equal to the CPU bit for bit over the first 1,000,000 events; (20b)
    ``SELECT cnt, COUNT(*), SUM(total) FROM (SELECT key, COUNT(*) AS cnt,
    SUM(value) AS total FROM t GROUP BY key) GROUP BY cnt`` over the
    ``datagen`` connector (4,000,000 records, 1,000,000 keys, batches of
    1<<16): the upsert-materialized counts equal a NumPy oracle exactly and
    the sums within 1e-3 of its float64 sums (float32 accumulators over
    ~4M signed adds); over 1,000,000 records the final rows and the raw
    changelog (emission order) card == CPU bit for bit, and a DataStream
    ``key_by("key").sum("value")`` job card == CPU; (20c) the Q5 Top-N
    pattern in SQL (HOP COUNT per auction, ``ROW_NUMBER() OVER (PARTITION
    BY window_end ORDER BY num DESC)``, ``rownum <= 1``) over 10M bids at
    ``parallelism.default: 8``, so the windows run on the mesh engine with
    the rank kernel: each window's winner is one of phase 5's oracle's
    tied winners with its count; (20d) the ordered fold's signed routes
    (``flat_scatter_signed``'s float leaves) in float64 and float32 held
    bit for bit to their plain version and timed at row 4's batch (1<<16
    lanes into ~60k live slots of a 1<<17 plane) and 20(b)'s second level
    (130,000 lanes of both signs into a few dozen slots), with both
    bounds. ``python3 -c 'import torch, chip_smoke;
    chip_smoke.phase_sql(torch)'`` runs phase 20 alone
    (``phase_sql(torch, "cpu", small=True)`` rehearses it without a card).
21. OVER, the lookup join into a filesystem table, EXPLAIN and 11d
    (after phase 20): (21a) both OVER engines at ``tools/bench_over.py``'s
    shape (ROWS 16 PRECEDING, SUM/AVG/MIN/MAX, batches of 50,000 rows, 3
    warm fires then 10 timed — 20 in ``tools/bench_over.py``, cut when
    phase 25 came —, at 100, 2,000 and 50,000 keys; the host
    engine at 50,000 keys times 2 fires, its per-key loop taking ~2 s a
    fire): rows/s of each, the device program's kernel and copy ms, its
    launches a fire and its share of the fire's wall (torch.profiler over
    4 more fires); the device rows equal the host rows over every fire
    both ran (keys, timestamps, values, MIN and MAX exactly; SUM and AVG
    within rtol 2e-4, atol 1e-5, the reference's own tolerance), 0
    degrades; then row 4's stream (4 partitions, 10,000 keys, 100,000
    events/s) cut to 2,000,000 events through SQL ``SUM`` and ``COUNT``
    OVER a RANGE 10 s frame on the device engine, every row against a
    float64 NumPy oracle (counts exactly, sums within that tolerance);
    (21b) phase 5's bids cut to 1,000,000 (JSON encoding of the result
    rows sets the pace; 2,000,000 until phase 24 came), enriched with
    their auction's category by
    a lookup join (``TableLookupFunction`` over 100,000 auction rows from
    ``default_rng(21)``, an LRU cache of 1<<17), HOP(2 s, 10 s)
    ``SUM(price) GROUP BY auction, category`` at ``parallelism.default:
    8`` (the mesh engine, the rank kernel and the ordered fold), ``INSERT
    INTO`` a 'filesystem' table, batches of 1<<16, a checkpoint every 4:
    the first run fails after checkpoint 2, a fresh job resumes from the
    checkpoints; the committed rows hold each (auction, window) exactly
    once with its auction's category, every sum equal to phase 6's
    stream-order float32 oracle bit for bit; events/s, the cache hit
    rate, the parts committed and the restore ms printed; (21c) the
    ``EXPLAIN`` text of row 4's query, 20(c)'s SQL Q5 at P=8 and 21(a)'s
    OVER query; (21d) ``ML_PREDICT`` with a ``TorchModel`` (an MLP of 2
    layers, width 64, float32, weights from a seed) on the card feeding a
    tumbling ``SUM`` over 1,000,000 records: its predictions within rtol
    1e-5, atol 1e-5 of the same module on the CPU and the window sums
    within rtol 1e-4, atol 1e-3 of the CPU job's; ``state.backend:
    host-heap`` on Q5-revenue at P=1 over 2,000,000 bids equal to the
    card's state bit for bit; ``SavepointReader`` over 19(c)'s stop
    savepoint: its keyed rows and count sums equal the state restored on
    the card; a DataStream V2 keyed process job (a ``DeviceValueState``
    count per key over 1,000,000 records) card == CPU == ``np.bincount``.
    ``python3 -c 'import torch, chip_smoke;
    chip_smoke.phase_slice21(torch)'`` runs phase 21 alone without the
    savepoint reader (``phase_slice21(torch, "cpu", small=True)``
    rehearses it without a card).
22. the stage executor, the metric tree and the flight recorder (after
    phase 21): (22a) phase 6's Q5-revenue job (HOP 10 s / 2 s, float32
    ``.sum("price")``, 100k auctions, 10M bids) under
    ``execution.stage-parallelism: 4``, ``source-parallelism: 1`` and
    ``execution.local-agg: false`` (four keyed subtask threads, each a
    single-device engine on the card): every (auction, window) sum equal
    bit for bit to phase 6's stream-order oracle (which phase 8's
    single-slot card run equals too); events/s and the ordered fold's
    launches printed; (22b) phase 5's Q5 under ``stage-parallelism: 2`` x
    ``stage-mesh-devices: 4`` (each subtask a 4-shard mesh engine over its
    key-group range) on 10M bids: the largest count of every window
    across the subtasks' arg-max rows, and its winners, equal phase 5's
    oracle; the rank's launches (> 0) and events/s printed; (22c)
    22(a)'s job in batches of 1<<19 with a checkpoint every 2 source
    batches crashes at 4 subtasks (an injected failure past 4M records
    once checkpoint 2 is durable; past 4M the failing map holds each
    batch 0.5 s until then — 0.2 s until phase 25 came: on a slow host the
    unaligned run's stream ended before checkpoint 2 was durable), and
    resumes from the newest checkpoint at 2
    subtasks and again single-slot; then once more with unaligned
    checkpoints, resumed at 4 subtasks: every row of every run equal to
    the oracle bit for bit, and each run pair covering every (auction,
    window) of the oracle; checkpoint bytes, restore ms and records
    replayed printed; (22d) 22(a)'s job in batch mode over
    ``shuffle.service: sort-merge`` (the native codec's runs, checked to
    be built), cut to 2M bids, under ``memory.device.size`` of 8 GiB: rows equal to the oracle
    of 2M bids; the bytes spilled, the pool's reservations and
    ``torch.cuda.max_memory_allocated`` printed; (22e) phase 5's Q5 at
    P=8 on 10M bids with the flight recorder on (the default, in this
    warm process) and off (``FLINK_TPU_FLIGHT_RECORDER=0``, read at
    import, in a fresh process warmed by an untimed run over 2M bids):
    events/s of both runs and the on-run's spans by kind (the off-run
    records none and fires the same rows); its
    Perfetto JSON loads and holds the executor's and the engine's kinds;
    ``result.registry`` holds the window operator's ``window`` gauges and
    ``numLateRecordsDropped``, which equals the engine's count (0).
    ``python3 -c 'import torch, chip_smoke;
    chip_smoke.phase_stage(torch)'`` runs phase 22 alone
    (``phase_stage(torch, "cpu", small=True)`` rehearses it without a
    card).
23. the control plane and the Avro format (after phase 22): (23a) phase
    5's Q5 at P=8 on 10M bids (cut from 40M, as 19(c) and 22(b) cut it)
    through a MiniCluster of two in-process TaskExecutors
    (``heartbeat.interval-ms: 100``) into a ``JsonLinesFileSink`` (the
    graph is shipped to the TaskExecutor): the windows' winners equal
    phase 5's oracle; events/s beside the same job run directly; REST
    ``/overview``, ``/jobs``, ``/jobs/<id>``, the job's flamegraph route
    and ``/ui`` read while it runs; its archive read back through the
    history server; ``cli list`` and ``cli info`` against the REST port;
    (23b) the same job with a checkpoint every 2 source batches and a map
    that raises once after checkpoint 2 (a flag file), ``fixed-delay``,
    3 attempts, 10 ms: FINISHED at attempt 1, winners (last row per
    window) equal the oracle, the restore ms printed; then the
    TaskExecutor running attempt 0 killed after a checkpoint
    (``heartbeat.timeout-ms: 1000``, a 500 ms backoff so the killed
    attempt's thread winds down first): FINISHED, winners equal the
    oracle, the detection ms printed; (23c) ``JobClient.trigger_savepoint``
    while the job runs, ``stop_with_savepoint`` after about 5 batches,
    resumed through ``execute(restore_from=)`` on the card: the two parts'
    windows disjoint and their union equal to the oracle; (23d) two
    MiniClusters over one ``high-availability.storageDir``
    (``filesystem``): Q5 at P=8 on 2M bids submitted to the leader, the
    leader released after a checkpoint; the standby recovers the job from
    the ``JobGraphStore`` and finishes it on the card, winners equal to
    the 2M-bid oracle, the takeover ms printed; (23e) this script hosts a
    standalone JobManager (``cluster.task-executors: 0`` on a pinned
    ``rpc.port``) and a subprocess runs ``python3 -m flink_tpu_torch.cli
    taskexecutor`` on the card; ``remote_submit`` runs Q5 at P=8 on 2M
    bids there: winners equal the oracle, the subprocess reports its
    device and is stopped whatever the outcome; its rank launches come
    back in the job's metric snapshot (``kernels.*``); (23f) 22(a)'s
    Q5-revenue at 4 subtasks on 2M bids with subtasks 2-3 behind a second
    ``RpcService``: all 1,282,788 sums equal 22(d)'s 2M-bid oracle bit for
    bit; events/s, the bytes that crossed the socket and the fold's
    launches printed; (23g) BASELINE row 4's topic cut from 8M to 1M
    events and to 500k when phase 27 came (the codec runs per record in
    Python), each event encoded
    under a v1 writer schema and read under an evolved v2 (an added field
    with a default) through ``'format'='avro'`` into HOP(2 s, 10 s)
    ``SUM(value)``: every sum equal to the raw format's run (and the
    oracle) bit for bit; events/s of both formats and the fold's launches
    printed. ``python3 -c 'import torch, chip_smoke;
    chip_smoke.phase_cluster(torch)'`` runs phase 23 alone
    (``phase_cluster(torch, "cpu", small=True)`` rehearses it without a
    card).
24. point queries and the serving plane (after phase 23). Every run holds
    its end of stream (``flink_tpu_torch/benchmarks/held.py``) until the
    queries at the cut are done, then is released and fires as usual:
    (24a) phase 5's Q5 at P=8 on 10M bids through ``LocalExecutor`` with a
    ``ServingPlane`` bound to the job's control queue and 16 client
    threads issuing ``lookup_batch`` of 256 auctions from
    ``default_rng(24)`` with a 2 ms pause, from the first batch to the
    release (the reference's row-6 client shape,
    ``tools/bench_suite.py:303-325``): at the cut every one of the 100k
    auctions' ``{window_end: count}`` through the plane equals a NumPy
    oracle of the live slices composed in ``slice_ends_for_window`` order;
    after the release the windows' winners equal phase 5's oracle; the
    same job without the clients beside it; events/s to the cut with and
    without the clients, lookups/s, lookup p50/p99 ms and lookups per
    device batch printed; (24b) Q5-revenue (float32 ``.sum("price")``) at
    P=8 on the first 2M bids: every auction's ``{window_end: sum}`` at the
    cut on the card equals the port on the CPU at the same cut bit for
    bit, and the live-slice oracle (per-slice ``np.add.at`` in stream
    order, left-folded); the fired rows equal 22(d)'s oracle; (24c) 23(a)'s
    job (10M bids, two in-process TaskExecutors): ``QueryableStateClient``
    reads every auction in 256-key batches, equal to 24(a); one key
    through ``GET /jobs/<id>/state/<op>`` and ``cli query`` agrees with the
    client; lookups/s and p99 printed; (24d) 22(a)'s Q5-revenue at 4
    subtasks (one source subtask, no local combiner) on 2M bids: one
    ``StateQueryBatchRequest`` of every auction fans out to its owning
    subtasks, equal to 24(b) bit for bit; (24e) card == CPU bit for bit on
    4,096 keys from ``default_rng(24)`` at the cut: Q5-revenue at P=1 on
    2M bids in the slot layout under a 1<<17-slot budget (slices spilled)
    and in the pane layout (no spill tier), each also equal to the
    live-slice oracle; row 5's sessions at P=1 (1<<19 rows) and on the
    mesh engine at P=8 (1<<16 rows a shard), cut to 1M records, the paged
    tier evicting; the resident, spilled and paged shares of the pairs
    answered printed; (24f) host only: the native and the Python hot-row
    cache planes primed with 24(b)'s answers under one generation
    (``prime_batch``, re-primed until the native table has grown to hold
    every key): ``get_many`` and ``get_many_packed`` on all 100k auctions
    give the same values in both planes; probe lookups/s of each.
    ``python3 -c 'import torch, chip_smoke;
    chip_smoke.phase_serving(torch)'`` runs phase 24 alone
    (``phase_serving(torch, "cpu", small=True)`` rehearses it without a
    card).
25. multi-tenancy (after phase 24): (25a) one ``SessionCluster`` runs two
    tenants at P=8 with ``serving.replica`` on and a 1<<22-row quota
    each: phase 5's Q5 (HOP 10 s / 2 s, top-k 16, batches of 1<<20) on 2M
    bids (cut from phase 5's 40M: 10M until phase 27 came, when the whole
    script passed 1,000 s; two boundaries, each an incremental publish of
    a ~500k-row delta) and phase 6's Q5-revenue on 2M (cut from
    its 10M: 24(b)'s cut, whose card == CPU answers it reuses; batches of
    1<<19, four boundaries), while 16 client threads issue
    ``lookup_batch_packed`` of 256
    auctions with a 2 ms pause; at the held cut every auction's answer off
    the sealed generation equals the live engine's (``StateQueryBatch
    Request`` on the job's control queue) and the CPU port's (24(b)'s
    card == CPU answers for the revenue; the live-slice oracle for the
    counts), bit for bit, and a twelfth of them through the serving plane
    (hot cache and workers) too; after the release the Q5 winners and
    every revenue sum equal the oracles; the same pair again, fresh, on
    the warm cluster without clients (its cut checked on that twelfth
    only, to keep the script's time): 0 program-cache misses and a hit for
    each job; gates: >= 2 generations, a hot-cache hit, 0 quota
    violations; events/s with and without clients, lookups/s, lookup
    p50/p99 and each tenant's replica staleness p99 (sampled from its
    start to its cut, while it ingests) printed, 24(a)'s legacy-path p99
    beside them for the record; (25b) BASELINE row 6 with the reference's
    settings but cut in depth (``flink_tpu_torch/benchmarks/
    serving.py``: a warm job, then two fresh jobs at P=4, 4,096 keys,
    seed 13, tumbling 60 s ``.sum("value")``, batches of 4,096,
    ``latency.fire-deadline-ms`` 25, an 8,192-row quota, 16 clients of
    256 keys with a 2 ms pause, a 25 ms publish interval) on 20,000
    records a job, 5 % of the row's 400,000 (the clients' Python holds
    the GIL the one scheduler thread needs between its torch calls: 400k
    took 476.7 s on the card with the card idle; 40,000 until phase 27
    came): five batches a job, each boundary an incremental publish; at
    the row's 50k events/s of event
    time its 60 s windows fire only at the end of the stream at any depth
    up to 3M records, the row's own 400k included: the sinks equal the same jobs
    on the CPU bit for bit, the packed answers the dict answers; the
    reference's 350k lookups/s floor and 25 ms p99 printed beside the
    card's, not gated; (25c) BASELINE row 9 (``benchmarks/serving_mp.py``):
    2 spawned frontend processes over the owner's shared-memory arena,
    4,096 keys, 256-key batches, 2,000 batches each, priming every 25 ms:
    hit rate >= 0.98, no torn read surfaced, parity with the owner's dict
    oracle; (25d) ``run_crash_restore_verify_multi`` with two mesh window
    jobs at P=8 (tumbling 2 s float32 Sum, 16 steps of 1<<16 records),
    job a crashed at its 5th serving burst: each job's committed windows
    equal its fault-free oracle exactly and job b is never restored.
    ``python3 -c 'import torch, chip_smoke;
    chip_smoke.phase_tenancy(torch)'`` runs phase 25 alone
    (``phase_tenancy(torch, "cpu", small=True)`` rehearses it without a
    card).
26. Scale-out and skew (ROADMAP item 12g): (26a) BASELINE row 5c
    (``benchmarks/mesh_sessions.py --zipf``): 2M records (of the row's
    4M: the script's time), keys Zipf(1.1)
    over the 10M-key space, 400k events/s of event time, 2 s gap, P=8,
    1<<16 rows a shard (paged spill), the skew ladder live
    (``ShardLoadAccountant`` -> ``RebalancePolicy`` -> ``SkewResponder``:
    live key-group moves and hot-key splitting), and a uniform control
    of the same shape: Zipf and uniform events/s and their ratio, the
    rebalances, groups moved, keys split, salted records and fires, the
    imbalance on the contiguous layout and on the live table; fails as
    vacuous without a live move or a salted record; the Zipf run's exact
    splits and watermarks replayed without the ladder give every fired
    (key, start, end, sum) bit for bit (ones: integer-valued float32);
    (26b) Q5 at P=8 through ``LocalExecutor`` on 4M bids, a
    ``RescaleRequest`` to 4 shards after batch 4 and back to 8 after
    batch 10: rows bit-identical to the uninterrupted run and phase 5's
    oracle, each handoff's ms and rows moved printed; then
    ``autoscale.enabled`` on tools/autoscale_smoke.py's load ramp with
    the executor's controller on a fake clock and scripted signals: 2 ->
    4 -> 2 logical shards, two live handoffs, rows equal to the run
    without the autoscaler; (26c) the interval join (16 steps of two
    sides of 32,768 rows) and the mesh CEP engine (16 steps of 32,768
    events, the 3-stage within-50 pattern) at P=8, each resharded 8 -> 4
    mid-stream: outputs equal the runs without a reshard; (26d) a
    ``SessionCluster`` with two held Q5 jobs (1M bids, P=2, the replica
    on) and the arbiter ticking every 5 ms: at least one live rescale
    served, no rescale error, replica answers at the held cut equal the
    live engine's, each job's rows equal its solo run; (26e) the rank
    kernel against ``exchange_rank_flat_plain`` at D in {2, 3, 4, 7, 8}
    on Zipf-skewed destination columns routed by a rebalanced
    ``KeyGroupAssignment`` (R=8, C=131072): max abs err 0.
    ``python3 -c 'import torch, chip_smoke;
    chip_smoke.phase_scaleout(torch)'`` runs phase 26 alone
    (``phase_scaleout(torch, "cpu", small=True)`` rehearses it without a
    card).
27. The pod (ROADMAP item 12h): (27a) phase 5's Q5 at P=8 with
    ``shuffle.hosts: 2`` (the two-level exchange, 2x4 in one process) on
    4M bids: every window's winners equal the Q5 oracle; then Q5-revenue
    (float32 ``.sum("price")``) at 2x4 on 2M bids, every row equal bit
    for bit to the flat run of the same bids (stage 2 folds the float
    leaf in stream order through the ordered fold); the traffic split
    (rows within and across hosts) and the rank and fold launches of each
    stage printed; (27b) ``shuffle.mode: host`` on Q5 at P=8 (4M bids),
    rows equal 27(a)'s, and on the mesh session engine at P=8 (row 5's
    stream, 1M records, 1<<16 rows a shard), every fired session equal
    bit for bit to the device-mode run; (27c) BASELINE row 8 through
    ``benchmarks/multiproc.py`` at 1,048,576 records (4x the bench row):
    two processes on the card, 4 logical shards each, exchanging over
    gloo; the union equals the one-process run, rows cross, and the
    kill-1-of-2 leg restores only the dead host's ranges and ends equal;
    aggregate and one-process events/s, rows crossed, bytes through gloo
    and the route's ms a batch printed; (27d) the ``host.lost`` point at
    2x4 on the mesh window engine (8 batches of 65,536 records): one host
    declared dead, its ranges restored from their units, the committed
    rows equal the fault-free run's; then ``LookupRouter`` over the two
    hosts of a held 2x4 Q5 count engine (524,288 bids): its answers equal
    the engine's ``query_batch``, local and remote key counts printed; (27e)
    the rank kernel against ``exchange_rank_flat_plain`` at the stage-1
    (D = 4) and stage-2 (D = 2) shapes of Q5's first 1<<20 bids, 27(a)'s
    widths: max abs err 0. ``python3 -c 'import torch, chip_smoke;
    chip_smoke.phase_pod(torch)'`` runs phase 27 alone
    (``phase_pod(torch, "cpu", small=True)`` rehearses it without a
    card).

The launch counts of both kernels are set to 0 just before each of phases
5 to 8, 10, 11, 12(a), 13(a), 13(b), 13(c), both runs of 14(a) and 14(b),
15(a), 15(b), the card run of 15(d) and 15(e), 16(a), each card run of
16(b), the card run of 16(d), the card runs of 9(b), 17(a), 17(b), 17(c)
and 17(d), 18(a) and 18(b) (from the harness's first engine on: the
oracle runs before it), the card runs of 18(c), 18(d)'s watchdog run and
18(e)'s card engines, 19(a), 19(b)'s card run, each card run of
19(c), 20(a)'s measured and card runs, each card run of 20(b) and 20(c),
each run of 21(a)'s SQL job and 21(b), 21(d)'s card jobs, each
run of 22(a) to 22(e) (22(e)'s recorder-off run in its subprocess),
each run of 23(a) to 23(g) (23(e)'s in the TaskExecutor process, whose
counters start at 0 with it and come back through the job's metric
snapshot), each run of 24(a) to 24(e), each of 25(a)'s two cluster runs
and 25(b)'s and 25(d)'s runs, 26(a)'s three runs, 26(b)'s rescaled Q5
and autoscaled ramp, 26(c)'s resharded join and CEP runs and 26(d)'s
cluster run, each run of 27(a) and 27(b), 27(d)'s held engine and its
host-loss and fault-free runs (from the harness's first engine on: the
oracle runs before it) (27(c)'s kernels launch in its child processes
and are not read), and read just after; each phase
fails if
a kernel of its path did not launch (the rank at parallelism 8 — in 18(b) at D=8
before the loss and at D=7 after it, in 19(c) before the stop and after
the resume —; the ordered fold in phases 6, 8, 9(b), 11, 12, 13, 14(b),
15(e), 17(b), 17(c), 18(a), 18(b), 18(c), 19(b), 20(a), 20(b), 21(b),
22(a), 22(c), 22(d), 23(f), 23(g), 24(b), 24(d), 24(e), 25(a), 25(b),
25(d), 26(a), 26(b)'s ramp, 27(a)'s revenue (its stage 2), 27(b)'s
sessions and 21(d)'s ML job — row 1's `.sum` keeps a float32 leaf —, Count
being an integer fold; the rank in 20(c), 21(b), 22(b), 22(e), 23(a)-(e),
24(a)-(c), 25(a), 25(b), 25(d), 26(a)-(d), 27(a) and 27(b); 26(e)'s
and 27(e)'s comparison launches are not counted). 25(c) runs no kernel: its frontends
read the hot cache's shared memory on the host. 19(a), 19(d) and 21(a)
run no kernel of the two: the device value state's gather and its
stream-ordered put and the OVER device program are torch ops.

Prints the card's name and power limit early, one JSON line describing
every kernel, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Exits non-zero without a CUDA card, and when run without the repository.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
Q5_SHAPE = (8, 131072, 8)   # (R shards, C lanes per shard, D dests)
Q5_WIDTH = 32768            # a bucket width Q5's batches stage at
# Nexmark Q5 as bench.py runs it: auctions, events/s of event time, HOP
# size and slide (ms), top-k
AUCTIONS, RATE, SIZE, SLIDE, TOP_K = 100_000, 100_000, 10_000, 2_000, 16


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls, by CUDA events, after a
    warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us_per_call(fn, iters: int, names) -> dict:
    """Device time per call of ``fn`` spent in the kernels whose names
    contain each of ``names``, by torch.profiler over ``iters`` calls; a
    name the profiler did not see reads None (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    tot = {n: None for n in names}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for n in names:
            if n in ev.name:
                tot[n] = (tot[n] or 0.0) + ev.time_range.elapsed_us() / iters
    return tot


def reset_counts():
    from flink_tpu_torch.stateplane.fold import ordered_fold_planes
    from flink_tpu_torch.stateplane.rank import rank

    rank.launches = 0
    ordered_fold_planes.launches = 0


def read_counts() -> dict:
    from flink_tpu_torch.stateplane.fold import ordered_fold_planes
    from flink_tpu_torch.stateplane.rank import rank

    return {"exchange_rank": rank.launches,
            "ordered_fold": ordered_fold_planes.launches}


def phase_rank_parity(torch):
    from flink_tpu_torch.stateplane.rank import (
        exchange_rank_flat,
        exchange_rank_flat_plain,
        rank,
        rank_plain,
    )

    rng = np.random.default_rng(2024)
    cases = [(1, 1, 1), (1, 1024, 1), (2, 1025, 7), (8, 131072, 8),
             (8, 1 << 20, 64), (3, 4097, 33)]
    for _ in range(14):
        cases.append((int(rng.integers(1, 9)),
                      int(rng.integers(1, (1 << 20) + 1)),
                      int(rng.integers(1, 65))))
    for R, C, D in cases:
        d = torch.from_numpy(rng.integers(-3, D + 4, size=(R, C))
                             .astype(np.int32)).cuda()
        W = int(rng.integers(1, max(C // D, 1) + 2))
        before = rank.launches
        got = rank(d, D)
        got_flat = exchange_rank_flat(d, D, W)
        if rank.launches != before + 2:
            raise AssertionError(f"rank: {rank.launches - before} launches "
                                 "for two calls")
        want = rank_plain(d, D)
        want_flat = exchange_rank_flat_plain(d, D, W)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(
                f"rank kernel != rank_plain at R={R} C={C} D={D}: "
                f"{bad} lanes differ")
        if not torch.equal(got_flat, want_flat):
            bad = int((got_flat != want_flat).sum())
            raise AssertionError(
                f"flat rank != exchange_rank_flat_plain at R={R} C={C} "
                f"D={D} W={W}: {bad} lanes differ")
        if R == 1:  # the [C] form too
            if not torch.equal(rank(d[0], D), want[0]):
                raise AssertionError(f"1-D rank differs at C={C} D={D}")
        del want, want_flat
    print(f"phase 2: rank kernel (int32 and flat int64) bit-identical to "
          f"its plain versions on {len(cases)} shapes (D 1..64, R 1..8, C "
          f"up to {1 << 20}); one launch per call")


def phase_rank_timing(torch):
    from flink_tpu_torch.stateplane.rank import (
        exchange_rank_flat,
        exchange_rank_flat_plain,
    )

    R, C, D = Q5_SHAPE
    W = Q5_WIDTH
    rng = np.random.default_rng(7)
    d = torch.from_numpy(rng.integers(0, D + 1, size=(R, C))
                         .astype(np.int32)).cuda()
    err = (exchange_rank_flat(d, D, W)
           - exchange_rank_flat_plain(d, D, W)).abs().max().item()
    ms = cuda_ms(lambda: exchange_rank_flat(d, D, W), 200)
    plain_ms = cuda_ms(lambda: exchange_rank_flat_plain(d, D, W), 50)
    dev = device_us_per_call(lambda: exchange_rank_flat(d, D, W), 50,
                             ["rank_onepass"])["rank_onepass"]
    # the same bytes moved by torch's own elementwise cast (read int32,
    # write int64): what a memory-bound pass of this size takes here
    cast = device_us_per_call(lambda: d.to(torch.int64), 50,
                              ["elementwise"])["elementwise"]
    nbytes = (4 + 8) * R * C      # each lane read once, its int64 written
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3

    def ms_or_none(us):
        return "not measured" if us is None else f"{us / 1e3:.4f} ms"

    print(f"phase 3: flat rank at R={R} C={C} D={D} W={W}: wrapper call "
          f"{ms:.4f} ms, kernel device time {ms_or_none(dev)}, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({nbytes} B at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s); torch's int32->int64 cast of "
          f"the same lanes (same bytes) {ms_or_none(cast)} of device time")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "device_ms": None if dev is None else dev / 1e3,
            "cast_device_ms": None if cast is None else cast / 1e3,
            "max_abs_err": float(err)}


def _with_specials(rng, vals):
    """float32 values with NaN payloads (signalling, quiet, negative) and
    signed zeros: the max/min cases."""
    vals = vals.copy()
    pick = rng.random(vals.shape)
    vals[(pick >= 0.02) & (pick < 0.2)] = 0.0
    vals[(pick >= 0.2) & (pick < 0.4)] = -0.0
    bits = vals.view(np.int32)
    for j, b in enumerate((0x7FA00001, 0x7FC0000A, -0x003FFFFB,
                           -0x005FFFF0)):
        sel = (pick >= 0.005 * j) & (pick < 0.005 * (j + 1))
        bits[sel] = b + rng.integers(0, 1 << 12, int(sel.sum()))
    return vals


def _sum_specials(rng, vals):
    """float32 values with NaN payloads (signalling, quiet, negative) and
    +inf / -inf lanes, so that some slots meet inf - inf: the cases where
    the CPU's NaN bits differ from a plain card add."""
    vals = vals.copy()
    bits = vals.view(np.int32)
    pick = rng.random(vals.shape)
    for j, b in enumerate((0x7FA00001, 0x7FC0000A, -0x003FFFFB)):
        sel = (pick >= 0.001 * j) & (pick < 0.001 * (j + 1))
        bits[sel] = b + rng.integers(0, 1 << 12, int(sel.sum()))
    vals[(pick >= 0.003) & (pick < 0.013)] = np.inf
    vals[(pick >= 0.013) & (pick < 0.023)] = -np.inf
    return vals


def _bits(t):
    import torch

    return t.view(torch.int32 if t.element_size() == 4 else torch.int64)


def _q5_lanes(n: int, P: int):
    """(shard, slot) of each of Q5's first n bids, as the engine stages
    them: shards by key group, and per shard one slot (from 1; slot 0 is
    the identity) for each (auction, slice) pair, in first-seen order."""
    from flink_tpu_torch.benchmarks.nexmark import BidSource
    from flink_tpu_torch.parallel.shuffle import shard_records

    src = BidSource(total_records=n, num_auctions=AUCTIONS,
                    events_per_second_of_eventtime=RATE)
    src.open()
    b = src.poll_batch(n)
    keys = np.asarray(b["auction"], dtype=np.int64)
    pair = keys * (int(b.timestamps.max()) // SLIDE + 1) \
        + b.timestamps // SLIDE
    shards = shard_records(keys, P, 128)
    span = int(pair.max()) + 1
    u, first, inv = np.unique(shards * span + pair, return_index=True,
                              return_inverse=True)
    # number each shard's pairs 1, 2, ... in the order they first appear
    rank_in_shard = np.empty(len(u), dtype=np.int64)
    for p in range(P):
        mine = np.nonzero(u // span == p)[0]
        rank_in_shard[mine[np.argsort(first[mine], kind="stable")]] = \
            np.arange(1, len(mine) + 1)
    return shards, rank_in_shard[inv].astype(np.int32)


def phase_exchange_scatter(torch):
    from flink_tpu_torch.ops.segment_ops import torch_dtype
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.sharded_windower import build_mesh_steps
    from flink_tpu_torch.parallel.shuffle import (
        build_exchange_scatter,
        stage_device_exchange,
    )
    from flink_tpu_torch.windowing.aggregates import (
        CountAggregate,
        MaxAggregate,
        MinAggregate,
        SumAggregate,
    )

    P, cap, n = 8, 1 << 16, 1 << 20
    shards, slots = _q5_lanes(n, P)
    rng = np.random.default_rng(3)
    vals = rng.standard_normal(n).astype(np.float32)
    special = _with_specials(rng, vals)
    sum_special = _sum_specials(rng, vals)
    report = {}
    for name, agg, v in (("count", CountAggregate(), None),
                         ("sum_f32", SumAggregate("v"), sum_special),
                         ("max_f32", MaxAggregate("v"), special),
                         ("min_f32", MinAggregate("v"), special)):
        leaf = agg.leaves[0]
        cols = [slots] + ([v] if agg.input_leaves else [])
        dst, staged, width = stage_device_exchange(
            shards, P, cols, fills=[0] + [leaf.identity] * len(
                agg.input_leaves))
        outs = {}
        for dev in ("cpu", "cuda"):
            step = build_exchange_scatter(make_mesh(P, dev), agg)
            accs = (torch.full((P, cap), np.asarray(leaf.identity).item(),
                               dtype=torch_dtype(leaf.dtype), device=dev),)
            t = [torch.from_numpy(c).to(dev) for c in (dst, *staged)]
            accs = step(accs, t[0], t[1], tuple(t[2:]), width)
            outs[dev] = accs[0].cpu()
        differ = int((_bits(outs["cpu"]) != _bits(outs["cuda"])).sum())
        report[name] = {"slots_differing": differ}
        if name == "sum_f32":
            report[name]["nan_slots"] = int(torch.isnan(outs["cpu"]).sum())
            sum_plane = outs["cpu"]
        if differ:
            raise AssertionError(f"exchange+scatter {name}: card != CPU in "
                                 f"{differ} of {P * cap} slots")
    # the fire's slice merge of those sums, windows of 5 slices
    sm = torch.from_numpy(rng.integers(0, cap, (P, 4096, SIZE // SLIDE))
                          .astype(np.int32))
    fired = {}
    for dev in ("cpu", "cuda"):
        fire = build_mesh_steps(make_mesh(P, dev), SumAggregate("v"))[1]
        fired[dev] = fire((sum_plane.to(dev),), sm.to(dev))["sum_v"].cpu()
    differ = int((_bits(fired["cpu"]) != _bits(fired["cuda"])).sum())
    report["fire_sum_k5"] = {"rows_differing": differ,
                             "nan_rows": int(torch.isnan(fired["cpu"]).sum())}
    if differ:
        raise AssertionError(f"fire merge of float32 sums: card != CPU in "
                             f"{differ} of {fired['cpu'].numel()} rows")
    print("phase 4: exchange+scatter card == CPU bit for bit over Q5's first"
          f" 1<<20 bids (P=8, cap=1<<16; Sum with NaN payloads and +-inf), "
          f"and its fire over windows of 5 slices: {json.dumps(report)}")
    fold = phase_fold(torch, P, cap, shards, slots, vals, special)
    return report, fold


def _received(torch, P, dst, slots, vals, width):
    """The (slots [P, L] int32, values [P, L]) the exchange step hands its
    fold: the step's own rank, bucket scatter and transpose, on the
    card."""
    from flink_tpu_torch.stateplane.rank import exchange_rank_flat

    d = torch.from_numpy(dst).cuda()
    C = d.numel() // P
    W = int(width)
    flat = exchange_rank_flat(d.view(P, C), P, W)

    def exchange(col, fill):
        buf = torch.full((P, P * W + 1), fill, dtype=col.dtype,
                         device="cuda")
        buf.scatter_(1, flat, col.view(P, C))
        return (buf[:, :P * W].reshape(P, P, W).transpose(0, 1)
                .reshape(P, P * W))

    return (exchange(torch.from_numpy(slots).cuda(), 0),
            exchange(torch.from_numpy(vals).cuda(), 0.0))


def sm_clock_hz() -> float:
    """The card's top SM clock (``nvidia-smi clocks.max.sm``), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    return float(out) * 1e6


FADD_CYCLES = 4   # dependent FP32/FP64 add latency assumed for the chain


def fold_case(torch, name, acc, slots, v, clock_hz, stages=True,
              phase="4b"):
    """Hold the fold's grouping and its fold on the card against their
    plain versions on the CPU (bit for bit), and time them: the wrapper
    call, device µs per stage, torch.sort(stable=True) alone on the
    int64 flat targets p * cap + slot (the stage a sort-based grouping runs),
    the plain version and index_add_ on the card, and both bounds."""
    from flink_tpu_torch.stateplane.fold import (
        group_planes,
        group_planes_plain,
        ordered_fold_planes,
        ordered_fold_planes_plain,
    )

    P, cap = acc.shape
    got_g = group_planes(slots, v, cap)
    want_g = group_planes_plain(slots.cpu(), v.cpu(), cap)
    for p, ((gk, gv), (wk, wv)) in enumerate(zip(got_g, want_g)):
        if not (torch.equal(gk.cpu(), wk)
                and torch.equal(_bits(gv.cpu()), _bits(wv))):
            raise AssertionError(f"{name}: grouping != stable sort, plane "
                                 f"{p}")
    del got_g
    got = ordered_fold_planes(acc.clone(), slots, v, "sum")
    want = ordered_fold_planes_plain(acc.cpu(), slots.cpu(), v.cpu(), "sum")
    if not torch.equal(_bits(got.cpu()), _bits(want)):
        bad = int((_bits(got.cpu()) != _bits(want)).sum())
        raise AssertionError(f"{name}: ordered fold != its plain version "
                             f"in {bad} slots")
    err = float((got.cpu() - want).abs().nan_to_num().max())
    kept = [wk for wk, _ in want_g]
    real = sum(int(k.numel()) for k in kept)
    touched = sum(int(torch.unique(k).numel()) for k in kept)
    longest = max(int(torch.bincount(k.to(torch.int64)).max())
                  if k.numel() else 0
                  for k in kept)
    eb = v.element_size()
    nbytes = 4 * slots.numel() + eb * real + 2 * eb * touched
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    chain_ms = longest * FADD_CYCLES / clock_hz * 1e3
    target = (slots.to(torch.int64) + torch.arange(
        P, device="cuda", dtype=torch.int64)[:, None] * cap).reshape(-1)
    flat_v = v.reshape(-1)
    work = acc.clone()
    ms = cuda_ms(lambda: ordered_fold_planes(work, slots, v, "sum"), 20)
    sort_ms = cuda_ms(lambda: torch.sort(target, stable=True), 20)
    plain_ms = cuda_ms(lambda: ordered_fold_planes_plain(work, slots, v,
                                                         "sum"), 20)
    flat_acc = work.view(-1)
    index_add_ms = cuda_ms(lambda: flat_acc.index_add_(0, target, flat_v),
                           20)
    dev = device_us_per_call(
        lambda: ordered_fold_planes(work, slots, v, "sum"), 10,
        ["Memset", "histogram", "sort_pass", "fold_runs", "fold_long"]) \
        if stages else None
    # the hot run's measured pace, when the long-run stage was timed
    cycles_per_add = (dev["fold_long"] * 1e-6 * clock_hz / longest
                      if dev and dev.get("fold_long") and longest >= 1024
                      else None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        ordered_fold_planes(work, slots, v, "sum")
    host_ms = (time.perf_counter() - t0) / 50 * 1e3
    torch.cuda.synchronize()
    out = {"planes": P, "cap": cap, "lanes": slots.numel(),
           "real_lanes": real, "targets": touched, "longest_run": longest,
           "dtype": str(v.dtype).replace("torch.", ""),
           "ms": ms, "torch_sort_stable_ms": sort_ms, "plain_ms": plain_ms,
           "index_add_ms": index_add_ms, "device_us": dev,
           "host_enqueue_ms": host_ms, "long_run_cycles_per_add":
               cycles_per_add,
           "bytes_bound_ms": bytes_ms, "chain_bound_ms": chain_ms,
           "bound_ms": max(bytes_ms, chain_ms),
           "bound_by": "bytes" if bytes_ms >= chain_ms else "operations",
           "max_abs_err": err}
    print(f"phase {phase} {name}: P={P} cap={cap} {slots.numel()} lanes ({real} "
          f"kept, {touched} targets, longest run {longest}, "
          f"{out['dtype']}): grouping and fold bit-identical to their "
          f"plain versions; wrapper {ms:.4f} ms, torch.sort(stable) of the "
          f"flat targets alone {sort_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"index_add_ (not order-preserving) {index_add_ms:.4f} ms; "
          f"bound {out['bound_ms']:.5f} ms (bytes {bytes_ms:.5f}, chain "
          f"{chain_ms:.5f} at {clock_hz / 1e6:.0f} MHz, {FADD_CYCLES} "
          f"cycles an add); device us per stage {dev}; host enqueue "
          f"{host_ms:.4f} ms per call; long run at {cycles_per_add} "
          "cycles per add")
    return out


def phase_fold(torch, P, cap, shards, slots, vals, special):
    from flink_tpu_torch.parallel.shuffle import stage_device_exchange
    from flink_tpu_torch.stateplane.fold import (
        ordered_fold_planes,
        ordered_fold_planes_plain,
    )

    clock = sm_clock_hz()
    dst, (s_slots, s_vals), width = stage_device_exchange(
        shards, P, [slots, vals], fills=[0, 0.0])
    recv_s, v = _received(torch, P, dst, s_slots, s_vals, width)
    cases = {"q5": fold_case(torch, "q5", torch.zeros(P, cap,
                                                       device="cuda"),
                             recv_s, v, clock)}

    # Zipf(1.1) over 100k keys, one plane of cap 100001 (3 radix passes):
    # the hot key makes one long run
    n = recv_s.numel()
    rng = np.random.default_rng(11)
    p = np.arange(1, 100_001, dtype=np.float64) ** -1.1
    zkeys = rng.choice(100_000, size=n, p=p / p.sum())
    z_slots = torch.from_numpy((zkeys + 1).astype(np.int32)).cuda()[None]
    for dt, name in ((np.float32, "zipf_f32"), (np.float64, "zipf_f64")):
        z_v = torch.from_numpy(rng.standard_normal(n).astype(dt)).cuda()
        cases[name] = fold_case(
            torch, name, torch.zeros(1, 100_001, dtype=z_v.dtype,
                                     device="cuda"), z_slots, z_v[None],
            clock)

    # the exchange's shapes with planes of 1<<17 slots (3 passes)
    w_slots = torch.from_numpy(np.where(
        rng.random(recv_s.shape) < 0.5, 0,
        rng.integers(1, 1 << 17, recv_s.shape)).astype(np.int32)).cuda()
    w_v = torch.from_numpy(rng.standard_normal(recv_s.shape)
                           .astype(np.float32)).cuda()
    w_v[w_slots == 0] = 0.0
    cases["cap_1<<17"] = fold_case(
        torch, "cap_1<<17", torch.zeros(P, 1 << 17, device="cuda"),
        w_slots, w_v, clock, stages=False)

    # float max/min: torch's scatter_reduce_ on the card vs the CPU, and
    # the port's fold (the kernel's max/min modes) vs its plain one
    sp_dst, (sp_slots, sp_vals), sp_w = stage_device_exchange(
        shards, P, [slots, special], fills=[0, 0.0])
    sp_s, sp_v = _received(torch, P, sp_dst, sp_slots, sp_vals, sp_w)
    sp_t = (sp_s.to(torch.int64) + torch.arange(
        P, device="cuda", dtype=torch.int64)[:, None] * cap).reshape(-1)
    torch_diff, port_diff, minmax_ms = {}, {}, {}
    for reduce, ident in (("amax", -np.inf), ("amin", np.inf)):
        acc = torch.full((P, cap), float(ident))
        on_card = acc.cuda().view(-1).scatter_reduce_(
            0, sp_t, sp_v.reshape(-1), reduce=reduce)
        on_cpu = acc.clone().view(-1).scatter_reduce_(
            0, sp_t.cpu(), sp_v.reshape(-1).cpu(), reduce=reduce)
        torch_diff[reduce] = int((_bits(on_card.cpu()) != _bits(on_cpu))
                                 .sum())
        r = reduce[1:]
        # the exchange's padding lanes carry the identity (slot 0)
        v_r = sp_v.masked_fill(sp_s == 0, float(ident))
        card = ordered_fold_planes(acc.cuda(), sp_s, v_r, r)
        plain = ordered_fold_planes_plain(acc.clone(), sp_s.cpu(),
                                          v_r.cpu(), r)
        port_diff[r] = int((_bits(card.cpu()) != _bits(plain)).sum())
        work = acc.cuda()
        minmax_ms[r] = cuda_ms(
            lambda: ordered_fold_planes(work, sp_s, v_r, r), 20)
    if any(port_diff.values()):
        raise AssertionError(f"ordered fold max/min card != plain: "
                             f"{port_diff}")
    nan_lanes = int(torch.isnan(sp_v).sum())
    q5 = cases["q5"]
    out = {"cases": cases, "sm_clock_max_hz": clock,
           "fadd_cycles_assumed": FADD_CYCLES,
           "ms": q5["ms"], "plain_ms": q5["plain_ms"],
           "bound_ms": q5["bound_ms"], "bound_by": q5["bound_by"],
           "max_abs_err": q5["max_abs_err"],
           "torch_scatter_reduce_card_vs_cpu_slots_differing": torch_diff,
           "port_max_min_card_vs_plain_slots_differing": port_diff,
           "max_min_ms": minmax_ms, "max_min_nan_lanes": nan_lanes}
    print(f"phase 4b: max/min over {sp_v.numel()} lanes ({nan_lanes} NaN "
          f"payloads) card == plain ({port_diff}); {minmax_ms} ms a call "
          f"(sum at the same shapes {q5['ms']:.4f} ms); torch's own "
          f"scatter_reduce_ card vs CPU differs in {torch_diff} slots "
          "(recorded, not gated)")
    print("fold " + json.dumps(out))
    return out


def _run_job(torch, build, device, parallelism=8, layout="slots"):
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.q5_profile import P1_SETTINGS
    from flink_tpu_torch.connectors.sinks import CollectSink

    env = StreamExecutionEnvironment(Configuration({
        "parallelism.default": parallelism,
        "execution.micro-batch.size": 1 << 20,
        "execution.device": device,
        **(P1_SETTINGS if parallelism == 1 else {}),
        **({"state.window-layout": layout} if parallelism == 1 else {}),
    }))
    sink = CollectSink()
    build(env).sink_to(sink)
    reset_counts()
    t0 = time.perf_counter()
    result = env.execute()
    if device == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = read_counts()
    lat = result.metrics.get("window_fire_latency_ms", {})
    return sink, elapsed, counts, lat


def q5_oracle(source_cls, total, num_auctions, rate, size_ms, slide_ms):
    """{window_end: (max count, set of auctions with it)} by NumPy:
    per-slice bid counts, then each window sums its size/slide slices."""
    src = source_cls(total_records=total, num_auctions=num_auctions,
                     events_per_second_of_eventtime=rate)
    src.open()
    n_slices = ((total - 1) * 1000 // rate) // slide_ms + 1
    counts = np.zeros((n_slices, num_auctions), dtype=np.int64)
    while (b := src.poll_batch(1 << 22)) is not None:
        j = b.timestamps // slide_ms
        lo, hi = int(j.min()), int(j.max()) + 1
        counts[lo:hi] += np.bincount(
            (j - lo) * num_auctions + b["auction"],
            minlength=(hi - lo) * num_auctions).reshape(hi - lo, -1)
    k = size_ms // slide_ms
    csum = np.cumsum(np.concatenate(
        [counts, np.zeros((k - 1, num_auctions), np.int64)]), axis=0)
    out = {}
    for e in range(n_slices + k - 1):   # the window ending with slice e
        win = csum[e] - (csum[e - k] if e >= k else 0)
        best = int(win.max())
        if best:
            out[(e + 1) * slide_ms] = (
                best, set(np.nonzero(win == best)[0].tolist()))
    return out


class PaneTables:
    """Records the pane tables a run opens, and the lanes of the largest
    scatter each folds (flat index and values, on the host)."""

    def __init__(self):
        from flink_tpu_torch.state.pane_table import PaneTable

        self.cls, self.tables, self.largest = PaneTable, [], None
        self._init, self._scatter = PaneTable.__init__, PaneTable.scatter_flat
        rec = self

        def init(table, *a, **k):
            rec._init(table, *a, **k)
            rec.tables.append(table)

        def scatter(table, flat, values, valued=False):
            if rec.largest is None or len(flat) > len(rec.largest[0]):
                rec.largest = (np.asarray(flat).copy(),
                               tuple(np.asarray(v).copy() for v in values))
            return rec._scatter(table, flat, values, valued)

        PaneTable.__init__, PaneTable.scatter_flat = init, scatter

    def close(self):
        self.cls.__init__, self.cls.scatter_flat = self._init, self._scatter

    def state(self) -> dict:
        t = self.tables[-1]
        return {"ring_rows": t.R, "capacity": t.capacity,
                "used_cols": t.used_cols, "state_bytes": t.device_bytes}


def phase_q5(torch, records: int, parallelism: int = 8, layout="slots"):
    from flink_tpu_torch.benchmarks.nexmark import BidSource, build_q5

    phase = 5 if parallelism == 8 else 7 if layout == "slots" else 10
    panes = PaneTables() if layout == "panes" else None
    try:
        sink, elapsed, counts, lat = _run_job(torch, lambda env: build_q5(
            env, BidSource(total_records=records, num_auctions=AUCTIONS,
                           events_per_second_of_eventtime=RATE),
            size_ms=SIZE, slide_ms=SLIDE, device_top_k=TOP_K), "cuda",
            parallelism, layout)
    finally:
        if panes is not None:
            panes.close()
    batches = -(-records // (1 << 20))
    if parallelism > 1 and counts["exchange_rank"] <= 0:
        raise AssertionError("Q5 ran without launching the rank kernel")
    got = {}
    for r in sink.rows():
        got.setdefault(r["window_end"], (r["count"], set()))[1].add(
            int(r["auction"]))
    t1 = time.perf_counter()
    want = q5_oracle_cached(records)
    oracle_s = time.perf_counter() - t1
    if set(got) != set(want):
        raise AssertionError(f"Q5 fired {len(got)} windows, oracle "
                             f"{len(want)}")
    for w, (best, winners) in want.items():
        g_best, g_winners = got[w]
        if g_best != best or not g_winners <= winners or \
                len(g_winners) != min(len(winners), TOP_K):
            raise AssertionError(f"Q5 window {w}: got ({g_best}, "
                                 f"{sorted(g_winners)[:5]}...), oracle "
                                 f"({best}, {sorted(winners)[:5]}...)")
    # windows where the top-k chose among more tied winners than k
    over_k = sum(len(winners) > TOP_K for _, winners in want.values())
    q5 = {"parallelism": parallelism, "layout": layout, "records": records,
          "elapsed_s": elapsed, "events_per_s": records / elapsed,
          "windows": len(got), "windows_with_more_ties_than_k": over_k,
          "batches": batches, "launches": counts,
          "fire_latency_ms": lat, "oracle_s": oracle_s}
    if panes is not None:
        q5["pane_state"] = panes.state()
    print(f"phase {phase}: Q5 P={parallelism} ({layout}) {records} records "
          f"in {elapsed:.3f} s = {records / elapsed:.0f} events/s; "
          f"{len(got)} windows match the oracle ({over_k} with more tied "
          f"winners than k={TOP_K}); launches {counts} over {batches} "
          f"batches; fire latency p50 {lat.get('p50')} ms p99 "
          f"{lat.get('p99')} ms" + (f"; pane state {q5['pane_state']}"
                                    if panes is not None else ""))
    print(f"Q5 P={parallelism} {layout} " + json.dumps(q5))
    return q5


def build_revenue(env, source):
    """Q5-revenue through the public API: float32 revenue per auction per
    sliding window."""
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
    from flink_tpu_torch.windowing.assigners import SlidingEventTimeWindows

    return (env.from_source(source,
                            WatermarkStrategy.for_bounded_out_of_orderness(0))
            .key_by("auction")
            .window(SlidingEventTimeWindows.of(SIZE, SLIDE))
            .sum("price"))


def revenue_oracle(source_cls, total, num_auctions, rate, size_ms,
                   slide_ms):
    """(sums [windows, auctions] float32, counts [windows, auctions]) by
    NumPy, window e ending with slice e: per-slice sums by np.add.at in
    stream order, then each window's slices folded left to right from 0."""
    src = source_cls(total_records=total, num_auctions=num_auctions,
                     events_per_second_of_eventtime=rate)
    src.open()
    k = size_ms // slide_ms
    n_slices = ((total - 1) * 1000 // rate) // slide_ms + 1
    sums = np.zeros((n_slices + 2 * (k - 1), num_auctions), np.float32)
    counts = np.zeros((n_slices + 2 * (k - 1), num_auctions), np.int64)
    flat_s, flat_c = sums.reshape(-1), counts.reshape(-1)
    while (b := src.poll_batch(1 << 22)) is not None:
        idx = ((b.timestamps // slide_ms) + (k - 1)) * num_auctions \
            + b["auction"]
        np.add.at(flat_s, idx, b["price"])
        flat_c += np.bincount(idx, minlength=flat_c.size)
    n_windows = n_slices + k - 1
    win = np.zeros((n_windows, num_auctions), np.float32)
    cnt = np.zeros((n_windows, num_auctions), np.int64)
    for j in range(k):                 # ((0 + s0) + s1) + ... + s(k-1)
        win = win + sums[j:j + n_windows]
        cnt += counts[j:j + n_windows]
    return win, cnt


#: records -> the revenue oracle's (sums, counts): phases 6, 8 and 22
#: check against the same arrays
_REVENUE_ORACLES = {}


def revenue_oracle_cached(records: int):
    from flink_tpu_torch.benchmarks.nexmark import BidSource

    if records not in _REVENUE_ORACLES:
        _REVENUE_ORACLES[records] = revenue_oracle(
            BidSource, records, AUCTIONS, RATE, SIZE, SLIDE)
    return _REVENUE_ORACLES[records]


def check_revenue_rows(res, want, cnt, label: str, full: bool = True):
    """Every fired (window, auction) sum of ``res`` equal to the oracle's
    bit for bit, each pair once; with ``full`` every pair the oracle has
    fired. Returns (rows, windows)."""
    e = np.asarray(res["window_end"]) // SLIDE - 1
    a = np.asarray(res["auction"]).astype(np.int64)
    s = np.asarray(res["sum_price"], dtype=np.float32)
    if len(s) and (e.min() < 0 or e.max() >= len(want)):
        raise AssertionError(f"{label} fired a window the oracle lacks")
    pair = e * AUCTIONS + a
    if len(np.unique(pair)) != len(pair):
        raise AssertionError(f"{label} fired a (window, auction) twice")
    present = cnt > 0
    if not present.reshape(-1)[pair].all() or (
            full and len(pair) != int(present.sum())):
        raise AssertionError(f"{label} fired {len(pair)} rows, oracle "
                             f"{int(present.sum())}")
    bad = int((want[e, a].view(np.int32) != s.view(np.int32)).sum())
    if bad:
        raise AssertionError(f"{label}: {bad} of {len(s)} fired sums "
                             "differ from the stream-order oracle")
    return len(s), int(present.any(axis=1).sum())


def phase_revenue(torch, records: int, parallelism: int = 8):
    from flink_tpu_torch.benchmarks.nexmark import BidSource

    phase = 6 if parallelism == 8 else 8
    sink, elapsed, counts, lat = _run_job(torch, lambda env: build_revenue(
        env, BidSource(total_records=records, num_auctions=AUCTIONS,
                       events_per_second_of_eventtime=RATE)), "cuda",
        parallelism)
    path = ("exchange_rank", "ordered_fold") if parallelism > 1 \
        else ("ordered_fold",)
    for name in path:
        if counts[name] <= 0:
            raise AssertionError(f"Q5-revenue ran without launching {name}")
    t1 = time.perf_counter()
    want, cnt = revenue_oracle_cached(records)
    oracle_s = time.perf_counter() - t1
    rows, windows = check_revenue_rows(sink.result(), want, cnt,
                                       "Q5-revenue")
    rev = {"parallelism": parallelism, "records": records,
           "elapsed_s": elapsed, "events_per_s": records / elapsed,
           "windows": windows, "rows": rows, "rows_differing": 0,
           "launches": counts, "fire_latency_ms": lat, "oracle_s": oracle_s}
    print(f"phase {phase}: Q5-revenue P={parallelism} {records} records in "
          f"{elapsed:.3f} s = {records / elapsed:.0f} events/s; all {rows} "
          f"fired (window, auction) sums over {windows} windows equal the "
          f"stream-order oracle bit for bit; launches {counts}; fire "
          f"latency p50 {lat.get('p50')} ms p99 {lat.get('p99')} ms")
    print(f"revenue P={parallelism} " + json.dumps(rev))
    return rev


def phase_fold_p1(torch):
    """One timed call of the ordered fold at the single-device engine's
    shape: a [1, 1<<22] float32 plane, 1<<20 lanes of Q5's first bids
    (one slot per (auction, slice) in first-seen order, prices as values),
    against its plain version on the same inputs; bound by the bytes it
    must move (4 B a lane of slots, 4 B a lane of values, a read and a
    write of each touched slot)."""
    from flink_tpu_torch.benchmarks.nexmark import BidSource
    from flink_tpu_torch.stateplane.fold import (
        ordered_fold_planes,
        ordered_fold_planes_plain,
    )

    n, cap = 1 << 20, 1 << 22
    _, slots = _q5_lanes(n, 1)
    src = BidSource(total_records=n, num_auctions=AUCTIONS,
                    events_per_second_of_eventtime=RATE)
    src.open()
    price = np.asarray(src.poll_batch(n)["price"], dtype=np.float32)
    s = torch.from_numpy(slots).cuda()[None]
    v = torch.from_numpy(price).cuda()[None]
    acc = torch.zeros(1, cap, device="cuda")
    got = ordered_fold_planes(acc.clone(), s, v, "sum")
    want = ordered_fold_planes_plain(acc.cpu(), s.cpu(), v.cpu(), "sum")
    if not torch.equal(_bits(got.cpu()), _bits(want)):
        raise AssertionError("ordered fold at [1, 1<<22] != its plain "
                             "version")
    touched = int(torch.unique(s).numel())
    nbytes = 8 * n + 8 * touched
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    work = acc.clone()
    ms = cuda_ms(lambda: ordered_fold_planes(work, s, v, "sum"), 20)
    plain_ms = cuda_ms(lambda: ordered_fold_planes_plain(work, s, v, "sum"),
                       20)
    out = {"planes": 1, "cap": cap, "lanes": n, "targets": touched,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": "bytes", "max_abs_err": 0.0}
    print(f"phase 8: ordered fold at [1, 1<<22] with {n} lanes ({touched} "
          f"targets): bit-identical to its plain version; {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bytes bound {bound_ms:.5f} ms")
    print("fold P=1 " + json.dumps(out))
    return out


def _revenue_rows(torch, records, device):
    """The sink rows of Q5-revenue in the pane layout on ``device``."""
    from flink_tpu_torch.benchmarks.nexmark import BidSource

    sink, elapsed, counts, _ = _run_job(torch, lambda env: build_revenue(
        env, BidSource(total_records=records, num_auctions=AUCTIONS,
                       events_per_second_of_eventtime=RATE)), device, 1,
        "panes")
    return sink, elapsed, counts


def phase_revenue_panes(torch, records: int, equal_records: int = 2_000_000):
    from flink_tpu_torch.benchmarks.nexmark import BidSource
    from flink_tpu_torch.stateplane.fold import (
        ordered_fold_planes,
        ordered_fold_planes_plain,
    )

    # (a) the card equals the CPU, rows in order, bit for bit
    card, _, _ = _revenue_rows(torch, equal_records, "cuda")
    cpu, cpu_s, _ = _revenue_rows(torch, equal_records, "cpu")
    card_rows, cpu_rows = card.result(), cpu.result()
    if sorted(card_rows.names()) != sorted(cpu_rows.names()):
        raise AssertionError("Q5-revenue panes: card and CPU columns differ")
    n_equal = len(cpu_rows)
    for name in cpu_rows.names():
        g, w = np.asarray(card_rows[name]), np.asarray(cpu_rows[name])
        if g.dtype != w.dtype or g.tobytes() != w.tobytes():
            raise AssertionError(f"Q5-revenue panes: column {name} of the "
                                 f"card's {len(g)} rows != the CPU's "
                                 f"{len(w)}")

    # (b) the main run: rows against the oracle
    panes = PaneTables()
    try:
        sink, elapsed, counts, lat = _run_job(torch, lambda env: build_revenue(
            env, BidSource(total_records=records, num_auctions=AUCTIONS,
                           events_per_second_of_eventtime=RATE)), "cuda", 1,
            "panes")
    finally:
        panes.close()
    if counts["ordered_fold"] <= 0:
        raise AssertionError("Q5-revenue panes ran without the ordered fold")
    res = sink.result()
    want, cnt = revenue_oracle_cached(records)
    e = np.asarray(res["window_end"]) // SLIDE - 1
    a = np.asarray(res["auction"]).astype(np.int64)
    s = np.asarray(res["sum_price"], dtype=np.float32)
    pair = e * AUCTIONS + a
    present = cnt > 0
    if e.min() < 0 or e.max() >= len(want) or \
            len(np.unique(pair)) != len(pair) or \
            len(pair) != int(present.sum()) or \
            not present.reshape(-1)[pair].all():
        raise AssertionError(f"Q5-revenue panes fired {len(pair)} rows, the "
                             f"oracle's windows hold {int(present.sum())}")
    w, n = want[e, a].astype(np.float64), cnt[e, a]
    if (w <= 0).any():
        raise AssertionError("Q5-revenue panes: a non-positive oracle sum")
    rel = np.abs(s.astype(np.float64) - w) / w
    bound = 2.0 * np.maximum(n - 1, 0) * 2.0 ** -24
    over = int((rel > bound).sum())
    if over:
        raise AssertionError(f"Q5-revenue panes: {over} sums beyond "
                             "2 (n - 1) 2^-24 of the oracle's")
    differ = int((want[e, a].view(np.int32) != s.view(np.int32)).sum())

    # (d) one timed fold at the run's [1, R*C] shape
    table = panes.tables[-1]
    flat, values = panes.largest
    R, C = table.R, table.capacity
    slots = torch.from_numpy(flat.astype(np.int32)).cuda()[None]
    vals = torch.from_numpy(values[0].astype(np.float32)).cuda()[None]
    acc = torch.zeros(1, R * C, device="cuda")
    got = ordered_fold_planes(acc.clone(), slots, vals, "sum")
    ref = ordered_fold_planes_plain(acc.cpu(), slots.cpu(), vals.cpu(),
                                    "sum")
    if not torch.equal(_bits(got.cpu()), _bits(ref)):
        raise AssertionError("ordered fold at [1, R*C] != its plain version")
    del got, ref
    real = int((slots != 0).sum())
    touched = int(torch.unique(slots[slots != 0]).numel())
    nbytes = 4 * slots.numel() + 4 * real + 8 * touched
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    work = acc.clone()
    ms = cuda_ms(lambda: ordered_fold_planes(work, slots, vals, "sum"), 20)
    plain_ms = cuda_ms(lambda: ordered_fold_planes_plain(work, slots, vals,
                                                         "sum"), 20)
    fold = {"planes": 1, "width": R * C, "ring_rows": R, "capacity": C,
            "lanes": slots.numel(), "real_lanes": real, "targets": touched,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "max_abs_err": 0.0}
    del work, acc
    out = {"parallelism": 1, "layout": "panes", "records": records,
           "elapsed_s": elapsed, "events_per_s": records / elapsed,
           "rows": len(s), "rows_bitwise_differing_from_slot_order": differ,
           "max_rel_err": float(rel.max()), "launches": counts,
           "fire_latency_ms": lat, "pane_state": panes.state(),
           "card_equals_cpu_rows": n_equal, "cpu_s": cpu_s,
           "fold_at_ring_shape": fold}
    print(f"phase 11: Q5-revenue P=1 (panes) — first {equal_records} bids: "
          f"all {n_equal} rows equal on the card and the CPU in order, bit "
          f"for bit; {records} bids in {elapsed:.3f} s = "
          f"{records / elapsed:.0f} events/s, {len(s)} rows fired as the "
          f"oracle's, every sum within 2 (n - 1) 2^-24 of it (max rel "
          f"{rel.max():.3g}; {differ} differ from the slot-order sum in "
          f"bits); launches {counts}; fire latency p50 {lat.get('p50')} ms "
          f"p99 {lat.get('p99')} ms; pane state {panes.state()}; ordered "
          f"fold at [1, {R}*{C}] with {slots.numel()} lanes ({touched} "
          f"targets): {ms:.4f} ms, plain {plain_ms:.4f} ms, bytes bound "
          f"{bound_ms:.5f} ms")
    print("revenue P=1 panes " + json.dumps(out))
    return out


def _spill_run(torch, device, bids, budget):
    """Fired batches and spill counters of a float32 Sum over ``bids`` on
    the single-device engine with a device budget of ``budget`` slots, and
    the most slices its spill tier held."""
    from flink_tpu_torch.core.records import KEY_ID_FIELD, RecordBatch
    from flink_tpu_torch.windowing.aggregates import SumAggregate
    from flink_tpu_torch.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.windowing.windower import SliceSharedWindower

    w = SliceSharedWindower(
        SlidingEventTimeWindows.of(SIZE, SLIDE), SumAggregate("v"),
        capacity=budget, spill={"device": device, "max_device_slots": budget})
    fired, peak = [], 0
    for keys, vals, ts in bids:
        w.process_batch(RecordBatch.from_pydict(
            {KEY_ID_FIELD: keys, "v": vals}, timestamps=ts))
        peak = max(peak, len(w.table.spill))
        fired.extend(w.on_watermark(int(ts.max()) - 1))
    fired.extend(w.on_watermark(1 << 62))
    return fired, w.spill_counters(), peak


def phase_spill(torch, records: int = 3_000_000, budget: int = 1 << 17):
    from flink_tpu_torch.benchmarks.nexmark import BidSource

    src = BidSource(total_records=records, num_auctions=AUCTIONS,
                    events_per_second_of_eventtime=RATE)
    src.open()
    rng = np.random.default_rng(3)
    bids = []
    while (b := src.poll_batch(1 << 18)) is not None:
        vals = _sum_specials(rng, rng.standard_normal(len(b))
                             .astype(np.float32))
        bids.append((np.asarray(b["auction"], dtype=np.int64), vals,
                     np.asarray(b.timestamps, dtype=np.int64)))
    t0 = time.perf_counter()
    card, card_counters, peak = _spill_run(torch, "cuda", bids, budget)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu, cpu_counters, _ = _spill_run(torch, "cpu", bids, budget)
    if peak == 0:
        raise AssertionError("forced-eviction run: nothing spilled")
    if len(card) != len(cpu):
        raise AssertionError(f"forced-eviction run: {len(card)} fired "
                             f"batches on the card, {len(cpu)} on the CPU")
    rows = nan_rows = 0
    for g, w in zip(card, cpu):
        for name in w.columns:
            gc, wc = np.asarray(g[name]), np.asarray(w[name])
            if gc.dtype.kind == "f":
                nan_rows += int(np.isnan(wc).sum())
                gc, wc = gc.view(np.int32), wc.view(np.int32)
            if gc.dtype != wc.dtype or not np.array_equal(gc, wc):
                raise AssertionError(f"forced-eviction run: column {name} "
                                     "differs between the card and the CPU")
        rows += len(w)
    if card_counters != cpu_counters:
        raise AssertionError(f"spill counters differ: card {card_counters},"
                             f" CPU {cpu_counters}")
    out = {"records": records, "max_device_slots": budget,
           "fired_batches": len(card), "rows": rows, "nan_rows": nan_rows,
           "peak_spilled_slices": peak, "spill_counters": card_counters,
           "card_s": card_s}
    print(f"phase 9: forced eviction (budget {budget} slots, up to {peak} "
          f"slices spilled): {len(card)} fired batches, {rows} rows "
          f"({nan_rows} NaN) equal on the card and the CPU bit for bit; "
          f"spill counters equal")
    print("spill " + json.dumps(out))
    return out


def sessions_of_stream(keys, vals, ts, split_of, wm_before):
    """Sessions by NumPy over a stream in arrival order: records sorted by
    (key, timestamp), stable; a new session where the key changes, where
    the gap to the key's previous record is above 2,000 ms, and where it
    is exactly 2,000 ms and the previous session had fired before the
    record arrived: the record lies in a later ingest split than its
    predecessor and the watermark before its split (``wm_before[split]``)
    reached the session's last millisecond (``t - 1``). ``split_of[i]``:
    the ingest split of record i. Returns ``(keys, starts, ends, float32
    stream-order sums, record counts)``, sorted by key and start."""
    from flink_tpu_torch.benchmarks.session_profile import ROW5_GAP

    order = np.lexsort((ts, keys))
    k, t, v = keys[order], ts[order], vals[order]
    sq = split_of[order]
    new = np.ones(len(k), dtype=bool)
    same = k[1:] == k[:-1]
    diff = t[1:] - t[:-1]
    closed = ((diff == ROW5_GAP) & (sq[1:] > sq[:-1])
              & (wm_before[sq[1:]] >= t[1:] - 1))
    new[1:] = ~same | (diff > ROW5_GAP) | closed
    first = np.nonzero(new)[0]
    n = np.diff(np.append(first, len(k)))
    sums = np.zeros(len(first), np.float32)
    for j in range(int(n.max())):   # stream order, in float32
        live = n > j
        sums[live] += v[first[live] + j]
    return k[first], t[first], t[first + n - 1] + ROW5_GAP, sums, n


def mesh_oracle(records: int, split_starts):
    """Phase 13(a)'s sessions by NumPy: the stream of
    ``benchmarks/mesh_sessions.py`` over ``records`` records, sums of
    ones, each record in the ingest split that the loop's
    ``split_starts`` (the first record of each split) place it in, the
    watermark before a split that of the record before it."""
    from flink_tpu_torch.benchmarks import mesh_sessions as ms

    starts = np.asarray(split_starts)
    keys, ts = (np.concatenate(c) for c in zip(*ms.stream_batches(records)))
    split_of = np.searchsorted(starts, np.arange(records), side="right") - 1
    wm_before = np.where(starts > 0, ts[np.maximum(starts - 1, 0)],
                         np.iinfo(np.int64).min // 2)
    return sessions_of_stream(keys, np.ones(records, np.float32), ts,
                              split_of, wm_before)


def session_oracle(records: int, batch: int):
    """Row 5's sessions by NumPy over the same stream, fed to the executor
    in micro-batches of ``batch``: the watermark before a batch is the
    previous batch's largest timestamp less 1 (bounded out-of-orderness
    0)."""
    from flink_tpu_torch.benchmarks.session_profile import row5_source

    src = row5_source(records)
    src.open()
    parts = []
    while (b := src.poll_batch(1 << 22)) is not None:
        parts.append((np.asarray(b["key"], np.int64),
                      np.asarray(b["value"], np.float32),
                      np.asarray(b.timestamps, np.int64)))
    keys, vals, ts = (np.concatenate(c) for c in zip(*parts))
    split_of = np.arange(records) // batch
    last = ts[np.minimum((np.arange(split_of[-1] + 1)) * batch,
                         records) - 1]
    wm_before = np.where(np.arange(len(last)) > 0, last - 1,
                         np.iinfo(np.int64).min // 2)
    return sessions_of_stream(keys, vals, ts, split_of, wm_before)


def _jittered_specials(base_cls, jitter: int):
    """A DataGenSource whose timestamps move back by up to ``jitter`` ms and
    whose values carry phase 4's max/min specials (NaN payloads, signed
    zeros), both fixed by the record indices: out of order, so sessions
    merge."""
    from flink_tpu_torch.connectors.sources import _splitmix64

    class Jittered(base_cls):
        def _generate(self, idx):
            b = super()._generate(idx)
            late = (_splitmix64(idx, 99) % np.uint64(jitter)).astype(np.int64)
            vals = _with_specials(np.random.default_rng(int(idx[0])),
                                  np.asarray(b["value"], np.float32))
            return b.with_column("value", vals).with_timestamps(
                b.timestamps - late)

    return Jittered


def _rows_equal(what, got, want):
    """Sink rows equal in order, every column bit for bit."""
    g, w = got.result(), want.result()
    if len(g) != len(w) or sorted(g.names()) != sorted(w.names()):
        raise AssertionError(f"{what}: {len(g)} rows on the card, {len(w)} "
                             "on the CPU")
    for name in w.names():
        a, b = np.asarray(g[name]), np.asarray(w[name])
        if a.dtype != b.dtype or a.tobytes() != b.tobytes():
            raise AssertionError(f"{what}: column {name} differs between "
                                 "the card and the CPU")
    return len(w)


def merge_plain(torch, acc, dst, src):
    """flat_merge_pairs' plain version on one float32 leaf: the moved
    values gathered first, folded by the ordered fold's plain version
    (``index_add_``: on the card its atomics give other bits), the sources
    reset."""
    from flink_tpu_torch.stateplane.fold import ordered_fold_planes_plain

    idx = src.to(torch.int64)
    moved = acc[idx]
    ordered_fold_planes_plain(acc.view(1, -1), dst.view(1, -1),
                              moved.view(1, -1), "sum")
    return acc.index_fill_(0, idx, 0.0)


def fold_at_ingest(torch, seen):
    """One timed ordered fold at row 5's ingest shape, on the inputs that
    the card's session run gave its last ingest fold with the most real
    lanes (``seen``: acc, slots, values, reduce): equal bit for bit to its plain
    version on the CPU (on the card the plain version's ``index_add_``
    atomics give other bits), then the wrapper's host ms, the device ms by
    CUDA events, the plain version's ms and the bytes bound (4 B of slot
    and 4 B of value per real lane, a read and a write of each touched
    slot; the lanes at slot 0 are padding)."""
    from flink_tpu_torch.stateplane.fold import (
        ordered_fold_planes,
        ordered_fold_planes_plain,
    )

    if not seen:
        raise AssertionError("phase 12(d): the session run made no ingest "
                             "fold to time")
    acc, s, v, reduce = seen["acc"], seen["slots"], seen["values"], \
        seen["reduce"]
    got = ordered_fold_planes(acc.clone(), s, v, reduce)
    want = ordered_fold_planes_plain(acc.cpu(), s.cpu(), v.cpu(), reduce)
    if not torch.equal(_bits(got.cpu()), _bits(want)):
        raise AssertionError("phase 12(d): the ordered fold at the ingest "
                             "shape != its plain version")
    real = s[s != 0]
    n, touched = int(real.numel()), int(torch.unique(real).numel())
    bound_ms = (8 * n + 8 * touched) / HBM_BYTES_PER_S * 1e3
    work = acc.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        ordered_fold_planes(work, s, v, reduce)
    wrapper_ms = (time.perf_counter() - t0) / 50 * 1e3
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: ordered_fold_planes(work, s, v, reduce), 50)
    plain_ms = cuda_ms(
        lambda: ordered_fold_planes_plain(work, s, v, reduce), 50)
    return {"planes": int(s.shape[0]), "cap": int(acc.shape[1]),
            "lanes": int(s.shape[1]), "real_lanes": n, "targets": touched,
            "wrapper_ms": wrapper_ms, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "max_abs_err": 0.0}


def phase_sessions(torch, records: int, equal_records: int = 2_000_000,
                   merge_records: int = 1_000_000):
    """Phase 12: BASELINE row 5 (sessions, 10M keys, the paged spill tier)
    through the public API at parallelism 1."""
    import flink_tpu_torch.native as native
    from flink_tpu_torch.benchmarks.session_profile import (
        ROW5_KEYS,
        ROW5_SETTINGS,
        row5_source,
        run_sessions,
    )
    from flink_tpu_torch.connectors.sources import DataGenSource
    from flink_tpu_torch.ops.segment_ops import pad_bucket_size
    from flink_tpu_torch.stateplane.families import flat_merge_pairs
    from flink_tpu_torch.windowing.aggregates import SumAggregate

    # (a) the full run, against the NumPy oracle
    fallbacks = native.native_fallbacks()
    reset_counts()
    sink, wall, result, eng = run_sessions(row5_source(records))
    counts = read_counts()
    if counts["ordered_fold"] <= 0:
        raise AssertionError("phase 12: the session run made no ordered-fold "
                             "launch")
    native_plane = (type(eng.meta).__name__ == "NativeSessionIntervalSet"
                    and eng.meta.native_sweep_s > 0
                    and native.native_fallbacks() == fallbacks)
    if not native_plane:
        raise AssertionError("phase 12: the native session plane did not run")
    spill = eng.spill_counters()
    if eng.late_records_dropped:
        raise AssertionError(f"phase 12: {eng.late_records_dropped} late "
                             "records dropped from a stream in order")
    if spill["rows_evicted"] <= 0 or spill["rows_reloaded"] <= 0:
        raise AssertionError(f"phase 12: the paged tier did not evict and "
                             f"reload ({spill})")
    lat = result.metrics.get("window_fire_latency_ms", {})
    state_bytes = sum(a.numel() * a.element_size() for a in eng.table.accs)
    res = sink.result()
    got_k = np.asarray(res["key"], np.int64)
    got_s = np.asarray(res["window_start"], np.int64)
    got_e = np.asarray(res["window_end"], np.int64)
    got_v = np.asarray(res["sum_value"], np.float32)
    o = np.lexsort((got_s, got_k))
    got_k, got_s, got_e, got_v = got_k[o], got_s[o], got_e[o], got_v[o]
    t0 = time.perf_counter()
    wk, ws, we, wv, wn = session_oracle(
        records, ROW5_SETTINGS["execution.micro-batch.size"])
    oracle_s = time.perf_counter() - t0
    if not (np.array_equal(got_k, wk) and np.array_equal(got_s, ws)
            and np.array_equal(got_e, we)):
        raise AssertionError(f"phase 12: {len(got_k)} session rows, the "
                             f"oracle's {len(wk)}: the (key, start, end) "
                             "multisets differ")
    rel = np.abs(got_v.astype(np.float64) - wv) / np.maximum(
        np.abs(wv.astype(np.float64)), np.finfo(np.float32).tiny)
    bound = 2.0 * (wn - 1) * 2.0 ** -24
    over = int((rel > bound).sum())
    if over:
        raise AssertionError(f"phase 12: {over} session sums beyond "
                             "2 (n - 1) 2^-24 of the oracle's")
    differ = int((got_v.view(np.int32) != wv.view(np.int32)).sum())

    # (b) the card against the CPU over the first 2M records; the card's
    # run keeps the inputs of its last ingest fold with the most real
    # (non-padding) lanes — a full batch, mid-stream, the table full — for
    # (d)
    import flink_tpu_torch.stateplane.fold as fold_mod

    launch, seen = fold_mod._launch, {}

    def capture(acc, slots, values, reduce, cap, fold):
        real = int((slots != 0).sum()) if fold else -1
        if fold and real >= seen.get("real", 0):
            seen.update(real=real, acc=acc.clone(), slots=slots.clone(),
                        values=values.clone(), reduce=reduce)
        return launch(acc, slots, values, reduce, cap, fold)

    fold_mod._launch = capture
    try:
        card, _, _, ceng = run_sessions(row5_source(equal_records))
    finally:
        fold_mod._launch = launch
    cpu, cpu_s, _, peng = run_sessions(row5_source(equal_records), "cpu")
    n_equal = _rows_equal("phase 12(b)", card, cpu)
    if ceng.spill_counters() != peng.spill_counters():
        raise AssertionError(f"phase 12(b): spill counters differ: card "
                             f"{ceng.spill_counters()}, CPU "
                             f"{peng.spill_counters()}")

    # (c) float32 Max over NaN payloads and signed zeros, out of order so
    # that sessions merge, under a budget of 1<<15 rows
    merge_settings = {"execution.micro-batch.size": 1 << 13,
                      "state.slot-table.capacity": 1 << 15,
                      "state.slot-table.max-device-slots": 1 << 15}
    src_cls = _jittered_specials(DataGenSource, 3_000)
    reset_counts()
    mcard, _, _, meng = run_sessions(
        src_cls(merge_records, 100_000, 400_000, seed=3), "cuda",
        merge_settings, agg="max", out_of_orderness=3_000)
    mcounts = read_counts()
    mcpu, _, _, mpeng = run_sessions(
        src_cls(merge_records, 100_000, 400_000, seed=3), "cpu",
        merge_settings, agg="max", out_of_orderness=3_000)
    m_equal = _rows_equal("phase 12(c)", mcard, mcpu)
    if meng.spill_counters() != mpeng.spill_counters() \
            or meng.merge_groups != mpeng.merge_groups:
        raise AssertionError("phase 12(c): spill counters or merges differ")
    if meng.merge_groups <= 0 or meng.spill_counters()["rows_evicted"] <= 0:
        raise AssertionError("phase 12(c): no merge or no eviction")

    # (d) one flat_merge_pairs at the largest merge group's lanes, on row
    # 5's table ([1<<19] float32); run (a) merges nothing (its timestamps
    # rise with the record index), so the group is run (c)'s
    cap = ROW5_SETTINGS["state.slot-table.capacity"]
    pairs = meng.merge_pairs_max
    size = pad_bucket_size(pairs)
    rng = np.random.default_rng(12)
    perm = rng.permutation(np.arange(1, cap))
    dst = np.zeros(size, np.int32)
    src = np.zeros(size, np.int32)
    dst[:pairs] = rng.choice(perm[:max(pairs // 2, 1)], pairs)
    src[:pairs] = perm[cap // 2:cap // 2 + pairs]
    d, s_ = torch.from_numpy(dst).cuda(), torch.from_numpy(src).cuda()
    acc0 = torch.from_numpy(rng.random(cap).astype(np.float32)).cuda()
    acc0[0] = 0.0
    prog = flat_merge_pairs(SumAggregate("value").leaves)
    got = prog((acc0.clone(),), d, s_)[0]
    want = prog((acc0.cpu(),), d.cpu(), s_.cpu())[0]
    if not torch.equal(_bits(got.cpu()), _bits(want)):
        raise AssertionError("phase 12(d): flat_merge_pairs on the card != "
                             "the CPU")
    work = acc0.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        prog((work,), d, s_)
    wrapper_ms = (time.perf_counter() - t0) / 50 * 1e3
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: prog((work,), d, s_), 50)
    plain_ms = cuda_ms(lambda: merge_plain(torch, work, d, s_), 50)
    touched = len(np.unique(dst[:pairs]))
    # per real pair: its dst and src, the moved value read and the source
    # reset; per dst slot a read and a write (padded lanes are the
    # program's own padding, not work)
    nbytes = 16 * pairs + 8 * touched
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    merge = {"table": cap, "pairs": pairs, "lanes": size,
             "dst_targets": touched, "wrapper_ms": wrapper_ms, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": "bytes"}
    ingest = fold_at_ingest(torch, seen)

    out = {"records": records, "keys": ROW5_KEYS, "elapsed_s": wall,
           "events_per_s": records / wall, "fire_latency_ms": lat,
           "spill_counters": spill,
           "late_records_dropped": eng.late_records_dropped,
           "state_bytes": state_bytes, "native_plane": native_plane,
           "native_sweep_s": eng.meta.native_sweep_s,
           "merge_groups": eng.merge_groups, "launches": counts,
           "sessions": len(wk), "sums_bitwise_differing": differ,
           "max_rel_err": float(rel.max()), "oracle_s": oracle_s,
           "card_equals_cpu_rows": n_equal, "cpu_s": cpu_s,
           "card_equals_cpu_max_rows": m_equal,
           "max_job": {"records": merge_records, "keys": 100_000,
                       "merge_groups": meng.merge_groups,
                       "merge_pairs_max": pairs,
                       "spill_counters": meng.spill_counters(),
                       "launches": mcounts},
           "merge_timing": merge, "ingest_fold_timing": ingest}
    print(f"phase 12: BASELINE row 5 sessions P=1, {records} records over "
          f"{ROW5_KEYS} keys in {wall:.3f} s = {records / wall:.0f} events/s; fire "
          f"latency p50 {lat.get('p50')} ms p99 {lat.get('p99')} ms; "
          f"{len(wk)} sessions equal to the oracle's (key, start, end) and "
          f"every sum within 2 (n - 1) 2^-24 ({differ} differ in bits); "
          f"spill {spill}; late records dropped "
          f"{eng.late_records_dropped}; state {state_bytes} B on the card; "
          f"native plane ran ({eng.meta.native_sweep_s:.3f} s in sweeps); "
          f"launches {counts}; (b) first {equal_records} records: "
          f"{n_equal} rows equal on the card and the CPU, spill counters "
          f"equal; (c) Max with NaN payloads, out of order: {m_equal} rows "
          f"equal, {meng.merge_groups} merge groups (largest {pairs} "
          f"pairs); (d) flat_merge_pairs at [{cap}] with {size} lanes: "
          f"wrapper {wrapper_ms:.4f} ms, device {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bytes bound {bound_ms:.5f} ms; the ingest "
          f"fold at [1, {cap}] with {ingest['lanes']} lanes "
          f"({ingest['real_lanes']} real, {ingest['targets']} targets): "
          f"wrapper {ingest['wrapper_ms']:.4f} ms, device "
          f"{ingest['ms']:.4f} ms, plain {ingest['plain_ms']:.4f} ms, bytes "
          f"bound {ingest['bound_ms']:.5f} ms")
    print("sessions " + json.dumps(out))
    return out


def mesh_merge_timing(torch, captured, reduce):
    """Phase 13(d): the mesh merge step alone at (c)'s largest merge group
    (its [P, M] blocks on (c)'s [P, cap] planes) for one float32 leaf of
    ``reduce``: the card equal to the CPU bit for bit, then the wrapper's
    host ms, the device ms by torch.profiler, the plain version's ms on
    the card (a gather, the ordered fold's plain version — ``index_add_``
    for sums, ``scatter_reduce_`` with the NaN rule for max —, a reset)
    and the bytes bound: 16 B per real pair (its dst and src, the moved
    value read, the source reset) plus 8 B per destination slot (a read
    and a write) at 3.35 TB/s."""
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.sharded_sessions import (
        build_session_merge_step,
    )
    from flink_tpu_torch.stateplane.fold import ordered_fold_planes_plain
    from flink_tpu_torch.windowing import aggregates as tagg

    agg = tagg.SumAggregate("value") if reduce == "sum" \
        else tagg.MaxAggregate("value")
    acc, d, s_ = captured["acc"], captured["dst"], captured["src"]
    P = int(acc.shape[0])
    if reduce == "sum":   # (c) is a Max job: Sum folds finite values
        rng = np.random.default_rng(13)
        acc = torch.from_numpy(rng.standard_normal(tuple(acc.shape))
                               .astype(np.float32)).cuda()
        acc[:, 0] = 0.0
    step = build_session_merge_step(make_mesh(P, "cuda"), agg)
    got = step((acc.clone(),), d, s_)[0]
    want = build_session_merge_step(make_mesh(P, "cpu"), agg)(
        (acc.cpu(),), d.cpu(), s_.cpu())[0]
    if not torch.equal(_bits(got.cpu()), _bits(want)):
        raise AssertionError(f"phase 13(d): the mesh merge step ({reduce}) "
                             "on the card != the CPU")
    work = acc.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        step((work,), d, s_)
    wrapper_ms = (time.perf_counter() - t0) / 50 * 1e3
    torch.cuda.synchronize()
    ms = device_us_per_call(lambda: step((work,), d, s_), 50, [""])[""]
    ms = None if ms is None else ms / 1e3
    event_ms = cuda_ms(lambda: step((work,), d, s_), 50)

    def plain():
        idx = s_.to(torch.int64)
        moved = torch.gather(work, 1, idx)
        ordered_fold_planes_plain(work, d, moved, reduce)
        work.scatter_(1, idx, float(agg.leaves[0].identity))

    plain_ms = cuda_ms(plain, 50)
    real = s_ != 0
    pairs = int(real.sum())
    dests = sum(int(torch.unique(d[p][real[p]]).numel()) for p in range(P))
    bound_ms = (16 * pairs + 8 * dests) / HBM_BYTES_PER_S * 1e3
    return {"reduce": reduce, "planes": P, "cap": int(acc.shape[1]),
            "lanes": int(d.shape[1]), "real_pairs": pairs,
            "dst_targets": dests, "wrapper_ms": wrapper_ms,
            "device_ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes"}


def phase_mesh_sessions(torch, equal_records: int = 2_000_000,
                        merge_records: int = 1_000_000):
    """Phase 13: BASELINE row 5 on the mesh session engine at P=8."""
    import flink_tpu_torch.native as native
    import flink_tpu_torch.parallel.sharded_sessions as ss
    import flink_tpu_torch.stateplane.fold as fold_mod
    from flink_tpu_torch.benchmarks import mesh_sessions as ms
    from flink_tpu_torch.benchmarks.session_profile import (
        row5_source,
        run_sessions,
    )
    from flink_tpu_torch.connectors.sources import DataGenSource
    from flink_tpu_torch.core.records import KEY_ID_FIELD

    # (a) the reference's mesh-sessions shape through the benchmark loop,
    # every fired session against the NumPy oracle; never cut
    records = ms.RECORDS
    ms.load_libraries("cuda")
    fallbacks = native.native_fallbacks()
    reset_counts()
    r = ms.run(records, "cuda", collect=True)
    counts = read_counts()
    eng = r.pop("engine")
    batches, starts = r.pop("batches"), r.pop("split_starts")
    if counts["exchange_rank"] <= 0 or counts["ordered_fold"] <= 0:
        raise AssertionError(f"phase 13(a): a kernel did not launch "
                             f"({counts})")
    if not (type(eng.meta).__name__ == "NativeSessionIntervalSet"
            and native.native_fallbacks() == fallbacks):
        raise AssertionError("phase 13(a): the native session plane did "
                             "not run")
    spill = r["spill"]
    if spill["rows_evicted"] <= 0 or spill["rows_reloaded"] <= 0:
        raise AssertionError(f"phase 13(a): the paged tier did not evict "
                             f"and reload ({spill})")
    if eng.late_records_dropped:
        raise AssertionError("phase 13(a): late records dropped from a "
                             "stream in order")
    got_k = np.concatenate([np.asarray(b[KEY_ID_FIELD], np.int64)
                            for b in batches])
    got_s = np.concatenate([np.asarray(b["window_start"], np.int64)
                            for b in batches])
    got_e = np.concatenate([np.asarray(b["window_end"], np.int64)
                            for b in batches])
    got_v = np.concatenate([np.asarray(b["sum_v"], np.float32)
                            for b in batches])
    o = np.lexsort((got_s, got_k))
    got_k, got_s, got_e, got_v = got_k[o], got_s[o], got_e[o], got_v[o]
    t0 = time.perf_counter()
    wk, ws, we, wv, wn = mesh_oracle(records, starts)
    oracle_s = time.perf_counter() - t0
    if not (np.array_equal(got_k, wk) and np.array_equal(got_s, ws)
            and np.array_equal(got_e, we)
            and got_v.tobytes() == wv.tobytes()):
        raise AssertionError(f"phase 13(a): {len(got_k)} sessions fired, the "
                             f"oracle's {len(wk)}: (key, start, end, sum) "
                             "differ")

    # (b) row 5's job at P=8 through env.execute, card against CPU, a
    # 1<<16-row budget per shard (eviction starts), deadline off
    p8 = {"parallelism.default": 8, "state.slot-table.capacity": 1 << 16,
          "state.slot-table.max-device-slots": 1 << 16}
    reset_counts()
    card, card_s, _, ceng = run_sessions(row5_source(equal_records), "cuda",
                                         p8)
    b_counts = read_counts()
    cpu, cpu_s, _, peng = run_sessions(row5_source(equal_records), "cpu", p8)
    n_equal = _rows_equal("phase 13(b)", card, cpu)
    if ceng.spill_counters() != peng.spill_counters():
        raise AssertionError(f"phase 13(b): spill counters differ: card "
                             f"{ceng.spill_counters()}, CPU "
                             f"{peng.spill_counters()}")
    if ceng.spill_counters()["rows_evicted"] <= 0:
        raise AssertionError("phase 13(b): no eviction")

    # (c) phase 12(c)'s out-of-order float32 Max with NaN payloads and
    # signed zeros at P=8 under 1<<12 rows a shard; the merges' ordered-
    # fold launches are counted and the largest merge group kept for (d)
    merge_settings = {"parallelism.default": 8,
                      "execution.micro-batch.size": 1 << 13,
                      "state.slot-table.capacity": 1 << 12,
                      "state.slot-table.max-device-slots": 1 << 12}
    build, merge = ss.build_session_merge_step, {"launches": 0, "real": -1}

    def counted_build(mesh, agg):
        step = build(mesh, agg)
        if mesh.device.type != "cuda":
            return step

        def counted(accs, dst, src):
            real = int((src != 0).sum())
            if real > merge["real"]:
                merge.update(real=real, acc=accs[0].clone(),
                             dst=dst.clone(), src=src.clone())
            before = fold_mod.ordered_fold_planes.launches
            out = step(accs, dst, src)
            merge["launches"] += (fold_mod.ordered_fold_planes.launches
                                  - before)
            return out
        return counted

    src_cls = _jittered_specials(DataGenSource, 3_000)
    ss.build_session_merge_step = counted_build
    try:
        reset_counts()
        mcard, _, _, meng = run_sessions(
            src_cls(merge_records, 100_000, 400_000, seed=3), "cuda",
            merge_settings, agg="max", out_of_orderness=3_000)
        c_counts = read_counts()
    finally:
        ss.build_session_merge_step = build
    mcpu, _, _, mpeng = run_sessions(
        src_cls(merge_records, 100_000, 400_000, seed=3), "cpu",
        merge_settings, agg="max", out_of_orderness=3_000)
    m_equal = _rows_equal("phase 13(c)", mcard, mcpu)
    if meng.spill_counters() != mpeng.spill_counters() \
            or meng.merge_groups != mpeng.merge_groups:
        raise AssertionError("phase 13(c): spill counters or merges differ")
    if meng.merge_groups <= 0 or meng.spill_counters()["rows_evicted"] <= 0 \
            or merge["launches"] <= 0:
        raise AssertionError(f"phase 13(c): no merge, no eviction or no "
                             f"ordered fold in merges ({merge['launches']})")

    # (d) the mesh merge step alone at (c)'s largest group
    timing = [mesh_merge_timing(torch, merge, red) for red in ("sum", "max")]

    for what, c in (("13(b)", b_counts), ("13(c)", c_counts)):
        if c["exchange_rank"] <= 0 or c["ordered_fold"] <= 0:
            raise AssertionError(f"phase {what}: a kernel did not launch "
                                 f"({c})")
    launches = {k: counts[k] + b_counts[k] + c_counts[k] for k in counts}
    lat = r["fire_latency_ms"]
    out = {"records": records, "events_per_s": r["events_per_s"],
           "wall_s": r["wall_s"], "fire_latency_ms": lat, "spill": spill,
           "rewrite_amplification": r["rewrite_amplification"],
           "breakdown": r["breakdown"], "sessions": len(wk),
           "oracle_s": oracle_s, "launches_a": counts,
           "launches": launches,
           "card_equals_cpu_rows": n_equal, "b_card_s": card_s,
           "b_cpu_s": cpu_s, "b_spill": ceng.spill_counters(),
           "card_equals_cpu_max_rows": m_equal,
           "max_job": {"records": merge_records,
                       "merge_groups": meng.merge_groups,
                       "merge_pairs_max": meng.merge_pairs_max,
                       "merge_fold_launches": merge["launches"],
                       "spill": meng.spill_counters()},
           "merge_timing": timing}
    print(f"phase 13: BASELINE row 5 on the mesh engine P=8, {records} "
          f"records: {r['events_per_s']:.0f} events/s, fire p50 "
          f"{lat['p50']:.2f} ms p99 {lat['p99']:.2f} ms ({lat['count']} "
          f"fires); {len(wk)} sessions equal to the oracle (key, start, "
          f"end, sum bits); spill {spill}; amplification "
          f"{r['rewrite_amplification']:.4f}; launches {counts}; (b) first "
          f"{equal_records} records at P=8 through env.execute: {n_equal} "
          f"rows equal on the card and the CPU, spill counters equal "
          f"({ceng.spill_counters()}); (c) Max with NaN payloads, out of "
          f"order, P=8: {m_equal} rows equal, {meng.merge_groups} merge "
          f"groups (largest {meng.merge_pairs_max} pairs a shard), "
          f"{merge['launches']} ordered-fold launches in merges; (d) "
          + "; ".join(f"{t['reduce']}: wrapper {t['wrapper_ms']:.4f} ms, "
                      f"device {t['device_ms']} ms, events "
                      f"{t['event_ms']:.4f} ms, plain {t['plain_ms']:.4f} "
                      f"ms, bound {t['bound_ms']:.7f} ms"
                      for t in timing))
    print("mesh_sessions " + json.dumps(out))
    return out


# ------------------------------------------------------- phase 14: restore

def _snap_diffs(got, want, path=""):
    """Paths where two checkpoint state dicts differ (arrays by dtype and
    bytes, other values by ==)."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [path or "/"]
        return [d for k in want
                for d in _snap_diffs(got[k], want[k], f"{path}/{k}")]
    if isinstance(want, np.ndarray):
        ok = (isinstance(got, np.ndarray) and got.dtype == want.dtype
              and got.shape == want.shape
              and got.tobytes() == want.tobytes())
        return [] if ok else [path]
    return [] if got == want else [path]


def _keyed_rows(batches, key, value):
    """{(key, window_start, window_end): value bits} of fired batches."""
    out = {}
    for b in batches:
        k = np.asarray(b[key], np.int64).tolist()
        st = np.asarray(b["window_start"], np.int64).tolist()
        en = np.asarray(b["window_end"], np.int64).tolist()
        v = np.asarray(b[value])
        bits = v.view(np.uint32 if v.itemsize == 4 else np.uint64).tolist()
        out.update(zip(zip(k, st, en), bits))
    return out


class FailingMap:
    """Lets records through until more than ``fail_after`` have passed,
    then raises (a task failure in front of the keyBy)."""

    def __init__(self, fail_after: int):
        self.seen = 0
        self.fail_after = fail_after

    def __call__(self, batch):
        self.seen += len(batch)
        if self.seen > self.fail_after:
            raise RuntimeError("injected failure")
        return batch


def _q5_with_map(env, records, fn):
    """Q5 as ``build_q5`` builds it, with a map named ``failmap`` between
    the source and the keyBy."""
    from flink_tpu_torch.benchmarks.nexmark import BidSource, _window_argmax
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
    from flink_tpu_torch.windowing.aggregates import CountAggregate
    from flink_tpu_torch.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.windowing.fire_projectors import TopKFireProjector

    src = BidSource(total_records=records, num_auctions=AUCTIONS,
                    events_per_second_of_eventtime=RATE)
    return (env.from_source(src,
                            WatermarkStrategy.for_bounded_out_of_orderness(0))
            .map(fn, name="failmap")
            .key_by("auction")
            .window(SlidingEventTimeWindows.of(SIZE, SLIDE))
            .aggregate(CountAggregate(),
                       fire_projector=TopKFireProjector("count", k=TOP_K))
            .map(_window_argmax("count"), name="hot_items_argmax"))


def _job(torch, build, device, settings, sink, restore_from=None):
    """``build(env)``'s job into ``sink`` through ``env.execute`` on
    ``device``: (result, wall s). A job that raises propagates; the rows
    that reached ``sink`` before stay there."""
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment

    env = StreamExecutionEnvironment(Configuration(
        {**settings, "execution.device": device}))
    build(env).sink_to(sink)
    t0 = time.perf_counter()
    result = env.execute("ckpt", restore_from=restore_from)
    if device == "cuda":
        torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def _ckpt_list(ckpts) -> str:
    return ", ".join(f"chk-{x['id']}{' delta' if x['incremental'] else ''}"
                     f" {x['bytes']} B in {x['write_ms']:.1f} ms"
                     for x in ckpts)


def ckpt_q5_crash(torch, records: int, tmp: str,
                  device: str = "cuda") -> dict:
    """14(a): Q5 at P=8 crashes at ~60 % of the stream and a fresh job
    resumes from the checkpoint root; the union of both sinks against
    phase 5's oracle in every window."""
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.nexmark import BidSource
    from flink_tpu_torch.checkpoint.storage import (
        read_checkpoint_chain,
        read_manifest,
        resolve_snapshot_dir,
    )
    from flink_tpu_torch.cluster.local_executor import LocalExecutor
    from flink_tpu_torch.connectors.sinks import CollectSink

    root = f"{tmp}/q5"
    settings = {
        "parallelism.default": 8, "execution.micro-batch.size": 1 << 20,
        "state.checkpoints.dir": root,
        "state.checkpoints.num-retained": 1000,
        "execution.checkpointing.every-n-source-batches": 8,
        "execution.checkpointing.incremental": True,
        "execution.checkpointing.incremental.full-every": 2}
    failing = FailingMap(int(records * 0.6))
    crashed = CollectSink()
    env = StreamExecutionEnvironment(Configuration(
        {**settings, "execution.device": device}))
    _q5_with_map(env, records, failing).sink_to(crashed)
    # the executor itself (what env.execute runs), so the crashed run's
    # checkpoint list (id, kind, bytes, write ms) outlives its failure
    executor = LocalExecutor(env.config)
    reset_counts()
    t0 = time.perf_counter()
    try:
        executor.run(env.get_stream_graph(), job_name="ckpt")
    except RuntimeError as e:
        if "injected failure" not in str(e):
            raise
    else:
        raise AssertionError("phase 14(a): the failing map did not fail")
    crash_s = time.perf_counter() - t0
    crash_counts = read_counts()
    crash_ckpts = executor.checkpoints
    snap_dir = resolve_snapshot_dir(root)
    restored_id = read_manifest(snap_dir)["checkpoint_id"]
    pos = next(v["source"]["emitted"]
               for v in read_checkpoint_chain(snap_dir).values()
               if "source" in v)
    restored = CollectSink()
    reset_counts()
    result, restore_run_s = _job(
        torch, lambda env: _q5_with_map(env, records, lambda b: b), device,
        settings, restored, restore_from=root)
    counts = read_counts()
    for what, c in (("crashed", crash_counts), ("restored", counts)):
        if device == "cuda" and c["exchange_rank"] <= 0:
            raise AssertionError(f"phase 14(a): the {what} run did not "
                                 f"launch the rank kernel ({c})")
    got = {}
    for sink in (crashed, restored):   # the restored run's rows win
        per = {}
        for r in sink.rows():
            per.setdefault(r["window_end"], (r["count"], set()))[1].add(
                int(r["auction"]))
        got.update(per)
    want = q5_oracle_cached(records)
    if set(got) != set(want):
        raise AssertionError(f"phase 14(a): {len(got)} windows, the oracle "
                             f"{len(want)}")
    for w, (best, winners) in want.items():
        g_best, g_winners = got[w]
        if g_best != best or not g_winners <= winners or \
                len(g_winners) != min(len(winners), TOP_K):
            raise AssertionError(f"phase 14(a): window {w} differs from "
                                 "the oracle")
    kinds = {c["incremental"] for c in crash_ckpts}
    if kinds != {False, True}:
        raise AssertionError("phase 14(a): the crashed run did not write "
                             f"full and delta checkpoints ({crash_ckpts})")
    return {"records": records, "crashed_run_checkpoints": crash_ckpts,
            "restored_run_checkpoints": result.metrics["checkpoints"],
            "restored_checkpoint": restored_id, "restored_position": pos,
            "crashed_at": failing.seen,
            "records_replayed": failing.seen - pos,
            "restore_ms": result.metrics["restore_ms"],
            "crashed_run_s": crash_s,
            "crashed_events_per_s": failing.seen / crash_s,
            "restored_run_s": restore_run_s,
            "restored_events_per_s": (records - pos) / restore_run_s,
            "windows": len(want), "launches_crashed": crash_counts,
            "launches": counts}


def _chaos_plan(chaos):
    """``tools/chaos_smoke.py``'s plan with its hits spread over phase
    14(b)'s run (one dispatch fence and one post-dispatch exchange point
    per batch, page reads from the 10th batch on, one torn-point hit per
    checkpoint)."""
    R = chaos.FaultRule
    return chaos.FaultPlan(rules=[
        R(pattern="mesh.dispatch_fence", nth=CHAOS_FENCE_NTH),
        R(pattern="spill.page_reload", nth=CHAOS_RELOAD_NTH),
        R(pattern="shuffle.device_exchange", nth=CHAOS_EXCHANGE_NTH),
        R(pattern="checkpoint.write.torn", nth=2, kind="drop"),
    ])


# phase 14(b)'s records (13(a)'s 4M cut to 2M — 31 batches — to keep the
# whole script under 950 s) and its schedule, a checkpoint after every
# 8th batch (the run is deterministic: a CPU run of this phase gave these
# places and 3 crashes, 3 restores, 5 checkpoints, the torn one skipped):
# the fence crash at the 10th fence (restore to batch 8); a page reload
# broken past its retries at the 400th reload; the second checkpoint
# written torn; the exchange crash at the run's 24th batch, restored past
# the torn checkpoint
CHAOS_RECORDS = 2_000_000
CHAOS_CHECKPOINT_EVERY = 8
CHAOS_FENCE_NTH = 10
CHAOS_RELOAD_NTH = 400
CHAOS_EXCHANGE_NTH = 24


def ckpt_mesh_chaos(torch, tmp: str, records: int, device: str = "cuda"):
    """14(b): crash-restore-verify of the mesh session engine at the
    mesh-sessions shape."""
    from flink_tpu_torch.benchmarks import mesh_sessions as ms
    from flink_tpu_torch.chaos import injection as chaos
    from flink_tpu_torch.chaos import harness
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.sharded_sessions import MeshSessionEngine
    from flink_tpu_torch.windowing.aggregates import SumAggregate
    from flink_tpu_torch.windowing.sessions import SessionWindower

    steps, starts, produced = [], [], 0
    for keys, ts in ms.stream_batches(records):
        starts.append(produced)
        produced += len(keys)
        steps.append((keys, np.ones(len(keys), np.float32), ts,
                      int(ts[-1])))
    restores = []

    class Engine(MeshSessionEngine):
        def _paged_restore_rows(self, key_ids, namespaces, leaves):
            super()._paged_restore_rows(key_ids, namespaces, leaves)
            restores.append({
                "rows": len(key_ids),
                "pages": sum(len(sp) for sp in self.spills),
                "resident_rows": sum(i.num_used for i in self.indexes)})

    mesh = make_mesh(ms.PARALLELISM, device)
    oracle_counts = {}

    def make_engine():
        if not oracle_counts:
            # the harness builds its first engine once the fault-free
            # oracle has run: from here on the counts are the engine's own
            oracle_counts.update(read_counts())
            reset_counts()
        return Engine(ms.GAP_MS, SumAggregate("v"), mesh,
                      capacity_per_shard=ms.BUDGET_PER_SHARD,
                      max_device_slots=ms.BUDGET_PER_SHARD)

    def make_oracle():
        return SessionWindower(ms.GAP_MS, SumAggregate("v"),
                               capacity=1 << 20, spill={"device": device})

    reset_counts()
    t0 = time.perf_counter()
    report = harness.run_crash_restore_verify(
        make_engine, make_oracle, steps, _chaos_plan(chaos), seed=7,
        ckpt_root=f"{tmp}/chaos", checkpoint_every=CHAOS_CHECKPOINT_EVERY,
        async_fires=True, check=False)
    wall = time.perf_counter() - t0
    committed = report.committed
    counts = read_counts()
    if report.diverged:
        raise AssertionError("phase 14(b): committed output diverged from "
                             f"the oracle: {report.divergences[:5]}")
    want_points = {"mesh.dispatch_fence", "spill.page_reload",
                   "shuffle.device_exchange", "checkpoint.write.torn"}
    if (report.crashes != 3 or report.restores != 3
            or report.corrupt_checkpoints_skipped < 1
            or set(report.faults_injected) != want_points
            or report.checkpoints_written < 4):
        raise AssertionError(f"phase 14(b): schedule missed: "
                             f"{report.signature()}, skipped "
                             f"{report.corrupt_checkpoints_skipped}")
    if device == "cuda" and (counts["exchange_rank"] <= 0
                             or counts["ordered_fold"] <= 0):
        raise AssertionError(f"phase 14(b): a kernel did not launch in the "
                             f"mesh engine ({counts})")
    if not restores or any(r["rows"] <= r["resident_rows"] for r in restores):
        raise AssertionError("phase 14(b): a restore did not go through "
                             f"the page tier ({restores})")
    keys = np.fromiter((k[0] for k in committed), np.int64, len(committed))
    st = np.fromiter((k[1] for k in committed), np.int64, len(committed))
    en = np.fromiter((k[2] for k in committed), np.int64, len(committed))
    sums = np.fromiter((f["sum_v"] for f in committed.values()),
                       np.float64, len(committed)).astype(np.float32)
    o = np.lexsort((st, keys))
    wk, ws, we, wv, _ = mesh_oracle(records, starts)
    if not (np.array_equal(keys[o], wk) and np.array_equal(st[o], ws)
            and np.array_equal(en[o], we)
            and sums[o].tobytes() == wv.tobytes()):
        raise AssertionError(f"phase 14(b): {len(committed)} committed "
                             f"sessions, the oracle's {len(wk)}: (key, "
                             "start, end, sum) differ")
    wms = sorted(report.checkpoint_write_ms)
    return {"records": records, "steps": len(steps),
            "signature": report.signature(),
            "corrupt_checkpoints_skipped": report.corrupt_checkpoints_skipped,
            "retries": report.retries, "points_hit": report.points_hit,
            "checkpoint_bytes": report.checkpoint_bytes,
            "checkpoint_write_ms_p50": wms[len(wms) // 2],
            "checkpoint_write_ms_max": wms[-1],
            "restore_ms": report.restore_ms,
            "events_replayed": report.events_replayed,
            "paged_restores": restores, "sessions": len(committed),
            "wall_s": wall, "launches": counts,
            "oracle_launches": oracle_counts}


def _revenue_build(records):
    from flink_tpu_torch.benchmarks.nexmark import BidSource

    return lambda env: build_revenue(env, BidSource(
        total_records=records, num_auctions=AUCTIONS,
        events_per_second_of_eventtime=RATE))


def _row5_build(records):
    from flink_tpu_torch.benchmarks.session_profile import (
        ROW5_GAP,
        row5_source,
    )
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
    from flink_tpu_torch.windowing.assigners import EventTimeSessionWindows

    return lambda env: (
        env.from_source(row5_source(records),
                        WatermarkStrategy.for_bounded_out_of_orderness(0))
        .key_by("key").window(EventTimeSessionWindows.with_gap(ROW5_GAP))
        .sum("value"))


def ckpt_card_equals_cpu(torch, tmp: str, name, build, settings, key,
                         value, device: str = "cuda",
                         restore_on_card: bool = False) -> dict:
    """14(c) for one job: the card's checkpoints equal the CPU's, and the
    CPU restoring the card's middle checkpoint fires the card's rows:
    those of the uninterrupted card run, or with ``restore_on_card`` (a
    job whose restore refolds its float partials, so its rows after a
    restore differ in the last bits from an uninterrupted run) all rows
    of the card restoring the same checkpoint."""
    from flink_tpu_torch.checkpoint.storage import read_checkpoint_chain
    from flink_tpu_torch.connectors.sinks import CollectSink

    t0 = time.perf_counter()
    sinks, ids = {}, {}
    for dev, tag in ((device, "card"), ("cpu", "cpu")):
        root = f"{tmp}/{name}-{tag}"
        sinks[tag] = CollectSink()
        _job(torch, build, dev, {
            **settings, "state.checkpoints.dir": root,
            "state.checkpoints.num-retained": 1000}, sinks[tag])
        ids[tag] = sorted(int(d[4:]) for d in os.listdir(root)
                          if d.startswith("chk-"))
    if ids["card"] != ids["cpu"] or len(ids["card"]) < 2:
        raise AssertionError(f"phase 14(c) {name}: checkpoints "
                             f"{ids['card']} on the card, {ids['cpu']} on "
                             "the CPU")
    for cid in ids["card"]:
        card = read_checkpoint_chain(f"{tmp}/{name}-card/chk-{cid}")
        cpu = read_checkpoint_chain(f"{tmp}/{name}-cpu/chk-{cid}")
        diffs = _snap_diffs(card, cpu)
        if diffs:
            raise AssertionError(f"phase 14(c) {name}: checkpoint {cid} "
                                 f"differs card vs CPU at {diffs[:5]}")
    mid = ids["card"][len(ids["card"]) // 2]
    restored = CollectSink()
    _job(torch, build, "cpu", settings, restored,
         restore_from=f"{tmp}/{name}-card/chk-{mid}")
    got = _keyed_rows(restored.batches, key, value)
    if restore_on_card:
        card_restored = CollectSink()
        _job(torch, build, device, settings, card_restored,
             restore_from=f"{tmp}/{name}-card/chk-{mid}")
        card_rows = _keyed_rows(card_restored.batches, key, value)
        bad = len(set(got) ^ set(card_rows))
    else:
        card_rows = _keyed_rows(sinks["card"].batches, key, value)
        bad = 0
    bad += sum(card_rows.get(k) != v for k, v in got.items())
    if not got or bad:
        raise AssertionError(f"phase 14(c) {name}: {bad} of {len(got)} rows "
                             "fired after the CPU restore differ from the "
                             "card's")
    size = sum(e.stat().st_size
               for e in os.scandir(f"{tmp}/{name}-card/chk-{mid}"))
    return {"job": name, "checkpoints": len(ids["card"]),
            "restored": mid, "restored_bytes": size,
            "rows_after_restore": len(got),
            "against": "card restore" if restore_on_card else "card run",
            "wall_s": time.perf_counter() - t0}


def ckpt_mutual(torch, records: int, device: str = "cuda") -> dict:
    """14(d): a P=8 mesh-sessions snapshot restored into the P=1
    SessionWindower mid-stream, and a P=1 snapshot into the P=8 engine,
    on the card; each finished run equals the uninterrupted one."""
    from flink_tpu_torch.benchmarks import mesh_sessions as ms
    from flink_tpu_torch.core.records import (
        KEY_ID_FIELD,
        TIMESTAMP_FIELD,
        RecordBatch,
    )
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.sharded_sessions import MeshSessionEngine
    from flink_tpu_torch.windowing.aggregates import SumAggregate
    from flink_tpu_torch.windowing.sessions import SessionWindower

    steps = list(ms.stream_batches(records))
    cut = len(steps) // 2

    def make(p):
        if p == 8:
            return MeshSessionEngine(
                ms.GAP_MS, SumAggregate("v"), make_mesh(8, device),
                capacity_per_shard=ms.BUDGET_PER_SHARD,
                max_device_slots=ms.BUDGET_PER_SHARD)
        return SessionWindower(ms.GAP_MS, SumAggregate("v"),
                               capacity=1 << 19,
                               spill={"device": device,
                                      "max_device_slots": 1 << 19})

    def feed(eng, part):
        out = []
        for keys, ts in part:
            eng.process_batch(RecordBatch({
                KEY_ID_FIELD: keys, "v": np.ones(len(keys), np.float32),
                TIMESTAMP_FIELD: ts}))
            out.extend(eng.on_watermark(int(ts[-1])))
        return out

    full, rows = {}, {}
    for p in (1, 8):
        eng = make(p)
        feed(eng, steps[:cut])
        rest = feed(eng, steps[cut:]) + eng.on_watermark(1 << 60)
        full[p] = _keyed_rows(rest, KEY_ID_FIELD, "sum_v")
    if full[1] != full[8]:
        raise AssertionError("phase 14(d): P=1 and P=8 differ uninterrupted")
    for src, dst in ((8, 1), (1, 8)):
        eng = make(src)
        feed(eng, steps[:cut])
        t0 = time.perf_counter()
        snap = eng.snapshot()
        snap_ms = (time.perf_counter() - t0) * 1e3
        other = make(dst)
        t0 = time.perf_counter()
        other.restore(snap)
        restore_ms = (time.perf_counter() - t0) * 1e3
        got = _keyed_rows(feed(other, steps[cut:])
                          + other.on_watermark(1 << 60), KEY_ID_FIELD,
                          "sum_v")
        if got != full[dst]:
            bad = sum(full[dst].get(k) != v for k, v in got.items())
            raise AssertionError(f"phase 14(d): P={src} -> P={dst} differs "
                                 f"({len(got)} rows, {bad} unequal, "
                                 f"{len(full[dst])} expected)")
        rows[f"{src}->{dst}"] = {"rows": len(got),
                                 "snapshot_rows": len(snap["table"][
                                     "key_id"]),
                                 "snapshot_ms": snap_ms,
                                 "restore_ms": restore_ms}
    return rows


def phase_checkpoints(torch, q5_records: int = 40_000_000,
                      phase5=None, device: str = "cuda") -> dict:
    """Phase 14: checkpoints, restore and crash-restore-verify on
    ``device`` (``"cpu"`` rehearses it on a host without a card; 14(c)
    then compares the CPU with itself)."""
    import tempfile

    from flink_tpu_torch.benchmarks import mesh_sessions as ms

    ms.load_libraries(device)
    with tempfile.TemporaryDirectory(prefix="ckpt-") as tmp:
        a = ckpt_q5_crash(torch, q5_records, tmp, device)
        # the fault schedule (CHAOS_*) is placed for CHAOS_RECORDS
        b = ckpt_mesh_chaos(torch, tmp, CHAOS_RECORDS, device)
        c = [
            ckpt_card_equals_cpu(
                torch, tmp, "revenue_slots_spill", _revenue_build(3_000_000),
                {"execution.micro-batch.size": 1 << 18,
                 "state.window-layout": "slots",
                 "state.slot-table.capacity": 1 << 17,
                 "state.slot-table.max-device-slots": 1 << 17,
                 "execution.checkpointing.every-n-source-batches": 3},
                "auction", "sum_price", device),
            # pre-aggregated partials (the default, as phases 10 and 11)
            ckpt_card_equals_cpu(
                torch, tmp, "revenue_panes", _revenue_build(2_000_000),
                {"execution.micro-batch.size": 1 << 18,
                 "state.window-layout": "panes",
                 "state.slot-table.capacity": 1 << 17,
                 "execution.checkpointing.every-n-source-batches": 2},
                "auction", "sum_price", device, restore_on_card=True),
            ckpt_card_equals_cpu(
                torch, tmp, "revenue_panes_full_harvest",
                _revenue_build(2_000_000),
                {"execution.micro-batch.size": 1 << 18,
                 "state.window-layout": "panes", "latency.pane-preagg": False,
                 "state.slot-table.capacity": 1 << 17,
                 "execution.checkpointing.every-n-source-batches": 2},
                "auction", "sum_price", device),
            # cut from 1M records under 1<<19 (P=1) and 1<<16 a shard
            # (P=8) with a checkpoint every 5 batches when phase 19 came:
            # half the records under half the budgets, so the paged tier
            # still evicts
            ckpt_card_equals_cpu(
                torch, tmp, "row5_p1", _row5_build(500_000),
                {"execution.micro-batch.size": 1 << 16,
                 "state.slot-table.capacity": 1 << 18,
                 "state.slot-table.max-device-slots": 1 << 18,
                 "execution.checkpointing.every-n-source-batches": 3},
                "key", "sum_value", device),
            ckpt_card_equals_cpu(
                torch, tmp, "row5_p8", _row5_build(500_000),
                {"parallelism.default": 8,
                 "execution.micro-batch.size": 1 << 16,
                 "state.slot-table.capacity": 1 << 15,
                 "state.slot-table.max-device-slots": 1 << 15,
                 "execution.checkpointing.every-n-source-batches": 3},
                "key", "sum_value", device),
        ]
        d = ckpt_mutual(torch, 1_000_000, device)
    launches = {k: a["launches_crashed"][k] + a["launches"][k]
                + b["launches"][k] for k in a["launches"]}
    out = {"q5_crash": a, "mesh_chaos": b, "card_equals_cpu": c,
           "mutual": d, "launches": launches,
           "phase5_events_per_s": (phase5 or {}).get("events_per_s")}
    print(f"phase 14(a): Q5 P=8 {a['records']} bids: crashed at record "
          f"{a['crashed_at']} ({a['crashed_events_per_s']:.0f} events/s) "
          "after checkpoints " + _ckpt_list(a["crashed_run_checkpoints"])
          + "; the restored run wrote "
          + _ckpt_list(a["restored_run_checkpoints"])
          + f"; restored chk-{a['restored_checkpoint']} at record "
          f"{a['restored_position']} in {a['restore_ms']:.1f} ms, "
          f"{a['records_replayed']} records replayed, the rest at "
          f"{a['restored_events_per_s']:.0f} events/s (phase 5: "
          f"{out['phase5_events_per_s']}); {a['windows']} windows equal "
          f"the oracle; launches crashed {a['launches_crashed']} restored "
          f"{a['launches']}")
    print(f"phase 14(b): mesh sessions P=8 {b['records']} records, "
          f"{b['steps']} batches: {b['signature']['crashes']} crashes, "
          f"{b['signature']['restores']} restores, "
          f"{b['corrupt_checkpoints_skipped']} corrupt checkpoint(s) "
          f"skipped, {b['signature']['checkpoints_written']} checkpoints "
          f"(bytes {b['checkpoint_bytes']}), write ms p50 "
          f"{b['checkpoint_write_ms_p50']:.1f} max "
          f"{b['checkpoint_write_ms_max']:.1f}, restore ms "
          f"{[round(x, 1) for x in b['restore_ms']]}, "
          f"{b['events_replayed']} records replayed, paged restores "
          f"{b['paged_restores']}; {b['sessions']} committed sessions equal "
          f"the NumPy oracle; {b['wall_s']:.1f} s; launches in the mesh "
          f"engine {b['launches']} (the fault-free oracle "
          f"{b['oracle_launches']})")
    print("phase 14(c): card == CPU checkpoints: " + "; ".join(
        f"{x['job']}: {x['checkpoints']} checkpoints equal, CPU restore of "
        f"chk-{x['restored']} ({x['restored_bytes']} B) fired "
        f"{x['rows_after_restore']} rows equal to the {x['against']}'s "
        f"({x['wall_s']:.1f} s)" for x in c))
    print("phase 14(d): " + "; ".join(
        f"P={k}: {v['snapshot_rows']} rows restored in "
        f"{v['restore_ms']:.1f} ms (snapshot {v['snapshot_ms']:.1f} ms), "
        f"{v['rows']} sessions equal" for k, v in d.items()))
    print("checkpoints " + json.dumps(out, default=str))
    return out



# ---------------------------------------------------------------- phase 15

#: tools/join_smoke.py's shape: keys, records a batch, slots (and device
#: budget) a shard a side, interval band (ms), watermark lag (ms), steps
JS_KEYS, JS_BATCH, JS_BUDGET, JS_BAND, JS_LAG, JS_STEPS = \
    40_000, 2048, 512, 2500, 3000, 8


def join_bench(torch, shape: str, records: int, device: str) -> dict:
    """15(a)/(b): ``benchmarks/joins.py``'s shape on ``device`` and its
    replay through the same engine with ``backend="host"``: every emitted
    batch equal (by digest of names, dtypes and bytes), in order."""
    from flink_tpu_torch.benchmarks import joins

    reset_counts()
    r = joins.run_shape(shape, records, device, check=True)
    r["launches"] = read_counts()
    tag = "15(a)" if shape == "q8" else "15(b)"
    if not r["equal_to_host_backend"]:
        raise AssertionError(
            f"phase {tag}: {shape} differs from the host backend at batch "
            f"{r['first_divergent_batch']} of {r['batches_compared']} "
            f"(spill {r['spill']} vs {r['host_backend']['spill']})")
    if not r["matches"] or not r["batches_compared"]:
        raise AssertionError(f"phase {tag}: {shape} emitted no match")
    if device == "cuda" and r["launches"]["exchange_rank"] == 0:
        raise AssertionError(f"phase {tag}: the rank kernel never launched")
    if shape == "10m" and (r["spill"]["rows_evicted"] == 0
                           or r["spill"]["cold_rows_served"] == 0):
        raise AssertionError(f"phase 15(b): the page tier was not used "
                             f"({r['spill']})")
    return r


def _js_batch(rng, t, name):
    from flink_tpu_torch.core.records import (
        KEY_ID_FIELD,
        TIMESTAMP_FIELD,
        RecordBatch,
    )

    keys = rng.integers(0, JS_KEYS, JS_BATCH).astype(np.int64)
    ts = t + np.arange(JS_BATCH, dtype=np.int64) // 4
    return RecordBatch({KEY_ID_FIELD: keys,
                        name: rng.random(JS_BATCH).astype(np.float32),
                        TIMESTAMP_FIELD: ts}), int(ts[-1]) + 1


def _js_run(kind: str, device: str, extra=None):
    """One engine at join_smoke's shape (P=8, 512 slots a shard a side,
    the band reaching into the pages): its batches, a snapshot after
    every step, the engine. ``extra(rng, batch)``, where given, returns
    each interval-join batch with more columns."""
    from flink_tpu_torch.joins import (
        MeshIntervalJoinEngine,
        MeshTemporalJoinEngine,
    )

    kw = dict(num_shards=8, device=device, capacity_per_shard=JS_BUDGET,
              max_device_slots=JS_BUDGET)
    out, snaps, t = [], [], 0
    if kind == "interval":
        eng = MeshIntervalJoinEngine(-JS_BAND, JS_BAND, **kw)
        rng = np.random.default_rng(23)
        for _ in range(JS_STEPS):
            for side, name in ((0, "v"), (1, "w")):
                b, t = _js_batch(rng, t, name)
                if extra is not None:
                    b = extra(rng, b)
                out += eng.process_batch(b, side)
            eng.on_watermark(t - JS_LAG)
            snaps.append(eng.snapshot())
    else:
        eng = MeshTemporalJoinEngine(**kw)
        rng = np.random.default_rng(29)
        for _ in range(JS_STEPS):
            b, _ = _js_batch(rng, t, "rate")
            out += eng.process_batch(b, 1)
            b, t = _js_batch(rng, t, "v")
            out += eng.process_batch(b, 0)
            out += eng.on_watermark(t - JS_LAG)
            snaps.append(eng.snapshot())
        out += eng.on_watermark(1 << 40)
    return out, snaps, eng


def join_smoke_card_equals_cpu(torch, device: str) -> dict:
    """15(c): both engines at join_smoke's shape on the card and on the
    CPU: every batch, every snapshot, the late-row count and every value
    plane outside the scratch slot 0 equal."""
    from flink_tpu_torch.benchmarks.joins import digest

    out = {}
    for kind in ("interval", "temporal"):
        card, card_snaps, ce = _js_run(kind, device)
        cpu, cpu_snaps, pe = _js_run(kind, "cpu")
        if [digest(b) for b in card] != [digest(b) for b in cpu]:
            raise AssertionError(f"phase 15(c): {kind} batches differ card "
                                 "vs CPU")
        for i, (a, b) in enumerate(zip(card_snaps, cpu_snaps)):
            diffs = _snap_diffs(a, b)
            if diffs:
                raise AssertionError(f"phase 15(c): {kind} snapshot {i} "
                                     f"differs card vs CPU at {diffs[:5]}")
        for side in (0, 1):
            for a, b in zip(ce._planes[side] or (), pe._planes[side] or ()):
                if a.shape != b.shape or a[:, 1:].cpu().numpy().tobytes() \
                        != b[:, 1:].numpy().tobytes():
                    raise AssertionError(f"phase 15(c): {kind} side {side} "
                                         "plane differs card vs CPU outside "
                                         "slot 0")
        sc = ce.spill_counters()
        if sc != pe.spill_counters() or not card:
            raise AssertionError(f"phase 15(c): {kind} spill counters "
                                 f"{sc} vs {pe.spill_counters()}")
        if kind == "interval" and (sc["rows_evicted"] == 0
                                   or sc["cold_rows_served"] == 0):
            raise AssertionError(f"phase 15(c): spill not engaged ({sc})")
        late = getattr(ce, "late_left_dropped", 0)
        if late != getattr(pe, "late_left_dropped", 0):
            raise AssertionError("phase 15(c): late_left_dropped differs")
        out[kind] = {"batches": len(card),
                     "matches": sum(len(b) for b in card),
                     "snapshots": len(card_snaps), "spill": sc,
                     "late_left_dropped": late}
    return out


def _join_side_source(seed: int, col: str, rows: int, keys: int,
                      rate: int):
    """One input of 15(d): ``rows`` records over ``keys`` keys at
    ``rate`` events/s of event time, made from ``seed``; its position is
    the rows emitted."""
    from flink_tpu_torch.connectors.sources import Source
    from flink_tpu_torch.core.records import RecordBatch

    class JoinSideSource(Source):
        def __init__(self):
            rng = np.random.default_rng(seed)
            self.keys = rng.integers(0, keys, rows).astype(np.int64)
            self.vals = rng.random(rows).astype(np.float32)
            self.ts = (np.arange(rows, dtype=np.int64) * 1000) // rate
            self.done = 0

        def poll_batch(self, max_records):
            if self.done >= rows:
                return None
            a, b = self.done, min(self.done + max_records, rows)
            self.done = b
            return RecordBatch.from_pydict(
                {"k": self.keys[a:b], col: self.vals[a:b]},
                timestamps=self.ts[a:b])

        def snapshot_position(self):
            return {"done": self.done}

        def restore_position(self, pos):
            self.done = pos["done"]

    return JoinSideSource()


JOIN_API_ROWS, JOIN_API_KEYS, JOIN_API_RATE, JOIN_API_BAND = \
    500_000, 200_000, 100_000, 1_000


def _interval_api_job(env):
    left = env.add_source(_join_side_source(
        1, "price", JOIN_API_ROWS, JOIN_API_KEYS, JOIN_API_RATE)).key_by("k")
    right = env.add_source(_join_side_source(
        2, "rate", JOIN_API_ROWS, JOIN_API_KEYS, JOIN_API_RATE)).key_by("k")
    return left.interval_join(right).between(-JOIN_API_BAND, JOIN_API_BAND)


def _pair_counts(batches):
    """Multiset of whole output rows (floats by their bits)."""
    import collections

    rows = collections.Counter()
    for b in batches:
        names = sorted(b.names())
        cols = [np.asarray(b[n]) for n in names]
        cols = [c.view(np.uint32) if c.dtype == np.float32 else c
                for c in cols]
        rows.update(zip(*[c.tolist() for c in cols]))
    return rows


def join_public_api(torch, tmp: str, device: str) -> dict:
    """15(d): the interval join through ``env.execute`` at
    ``parallelism.default=8`` with ``join.mode=device``: its rows equal
    ``join.mode=host``'s, its checkpoints on the card equal the CPU's."""
    from flink_tpu_torch.benchmarks.joins import digest
    from flink_tpu_torch.checkpoint.storage import read_checkpoint_chain
    from flink_tpu_torch.connectors.sinks import CollectSink

    base = {"parallelism.default": 8, "execution.micro-batch.size": 1 << 15,
            "state.slot-table.capacity": 1 << 16,
            "execution.checkpointing.every-n-source-batches": 16,
            "state.checkpoints.num-retained": 1000}
    sinks, results, walls = {}, {}, {}
    for tag, dev, mode in (("card", device, "device"),
                           ("cpu", "cpu", "device"),
                           ("host", "cpu", "host")):
        sinks[tag] = CollectSink()
        if tag == "card":
            reset_counts()
        results[tag], walls[tag] = _job(
            torch, _interval_api_job, dev,
            {**base, "join.mode": mode,
             "state.checkpoints.dir": f"{tmp}/join-{tag}"}, sinks[tag])
        if tag == "card":
            launches = read_counts()
    card_rows = _pair_counts(sinks["card"].batches)
    if not card_rows or card_rows != _pair_counts(sinks["host"].batches):
        raise AssertionError("phase 15(d): join.mode=device rows differ "
                             "from join.mode=host's")
    if [digest(b) for b in sinks["card"].batches] != \
            [digest(b) for b in sinks["cpu"].batches]:
        raise AssertionError("phase 15(d): card batches differ from the "
                             "CPU's")
    ids = sorted(int(d[4:]) for d in os.listdir(f"{tmp}/join-card")
                 if d.startswith("chk-"))
    if not ids:
        raise AssertionError("phase 15(d): no checkpoint written")
    for cid in ids:
        diffs = _snap_diffs(
            read_checkpoint_chain(f"{tmp}/join-card/chk-{cid}"),
            read_checkpoint_chain(f"{tmp}/join-cpu/chk-{cid}"))
        if diffs:
            raise AssertionError(f"phase 15(d): checkpoint {cid} differs "
                                 f"card vs CPU at {diffs[:5]}")
    if device == "cuda" and launches["exchange_rank"] == 0:
        raise AssertionError("phase 15(d): the rank kernel never launched")
    return {"rows": sum(card_rows.values()), "checkpoints": len(ids),
            "checkpoint_bytes": [c["bytes"] for c in
                                 results["card"].metrics["checkpoints"]],
            "events_per_s": 2 * JOIN_API_ROWS / walls["card"],
            "host_mode_events_per_s": 2 * JOIN_API_ROWS / walls["host"],
            "launches": launches}


def join_q7(torch, records: int, device: str) -> dict:
    """15(e): Nexmark Q7 at BASELINE row 3's settings
    (``tools/bench_suite.py:103-135``: 10k auctions, 100k events/s of
    event time, 2 s tumbling windows, micro-batches of 1<<16, state
    capacity 1<<20, P=1): every window's (max_price, winners) against
    ``oracle_q7``."""
    import collections

    from flink_tpu_torch.benchmarks.nexmark import (
        BidSource,
        build_q7,
        oracle_q7,
    )
    from flink_tpu_torch.connectors.sinks import CollectSink

    size = 2_000

    def source():
        return BidSource(total_records=records, num_auctions=10_000,
                         events_per_second_of_eventtime=100_000)

    sink = CollectSink()
    reset_counts()
    result, wall = _job(torch, lambda env: build_q7(env, source(), size),
                        device, {"execution.micro-batch.size": 1 << 16,
                                 "state.slot-table.capacity": 1 << 20},
                        sink)
    launches = read_counts()
    src = source()
    src.open()
    parts = []
    while True:
        b = src.poll_batch(1 << 20)
        if b is None:
            break
        parts.append(b)
    from flink_tpu_torch.core.records import RecordBatch, TIMESTAMP_FIELD

    bids = RecordBatch.concat(parts)
    want = oracle_q7(zip(bids["auction"].tolist(), bids["bidder"].tolist(),
                         bids["price"].tolist(),
                         bids[TIMESTAMP_FIELD].tolist()), size)
    got = collections.defaultdict(list)
    res = sink.result()
    if res["max_price"].dtype != np.float32:
        raise AssertionError("phase 15(e): max_price widened to "
                             f"{res['max_price'].dtype}")
    for w, a, bd, p, mx in zip(res["window_end"].tolist(),
                               res["auction"].tolist(),
                               res["bidder"].tolist(),
                               res["price"].tolist(),
                               res["max_price"].tolist()):
        got[w].append((a, bd, p, mx))
    bad = [w for w, (mx, winners) in want.items()
           if {r[2] for r in got.get(w, ())} != {mx}
           or {r[3] for r in got.get(w, ())} != {mx}
           or sorted((r[0], r[1]) for r in got[w]) != sorted(winners)]
    if bad or set(got) != set(want):
        raise AssertionError(f"phase 15(e): {len(bad)} of {len(want)} "
                             f"windows differ from oracle_q7 (first "
                             f"{sorted(bad)[:3]}), {len(set(got) ^ set(want))}"
                             " windows fired on one side only")
    if device == "cuda" and launches["ordered_fold"] == 0:
        raise AssertionError("phase 15(e): the ordered fold never launched "
                             "(the float32 window max)")
    return {"records": records, "windows": len(want), "rows": len(res),
            "events_per_s": records / wall, "wall_s": wall,
            "window_fire_latency_ms": result.metrics.get(
                "window_fire_latency_ms"),
            "launches": launches}


def phase_joins(torch, records: int = 4_000_000,
                q7_records: int = 10_000_000, device: str = "cuda") -> dict:
    """Phase 15: streaming joins on ``device`` (``"cpu"`` rehearses it on
    a host without a card; (c) and (d) then compare the CPU with
    itself)."""
    import tempfile

    if device == "cuda":
        from flink_tpu_torch.stateplane import cuda_build

        # both kernels (15(e)'s float max folds through the ordered fold)
        # are built before any timed run when the phase runs alone
        cuda_build.build_all()
    a = join_bench(torch, "q8", records, device)
    b = join_bench(torch, "10m", records, device)
    c = join_smoke_card_equals_cpu(torch, device)
    with tempfile.TemporaryDirectory(prefix="join-") as tmp:
        d = join_public_api(torch, tmp, device)
    e = join_q7(torch, q7_records, device)
    launches = {k: sum(x["launches"][k] for x in (a, b, d, e))
                for k in a["launches"]}
    for tag, r in (("15(a) Q8 shape", a), ("15(b) 10M-key shape", b)):
        lat = r["emit_latency_ms"]
        print(f"phase {tag}: {r['events']} records at "
              f"{r['events_per_s']:.0f} events/s, emit latency p50 "
              f"{lat['p50']:.2f} p99 {lat['p99']:.2f} ms over "
              f"{lat['count']} batches, {r['matches']} matches in "
              f"{r['batches_compared']} batches equal to the host backend's "
              f"(which ran {r['host_backend']['events_per_s']:.0f} events/s)"
              f", spill {r['spill']}, launches {r['launches']}")
    print("phase 15(c): card == CPU at join_smoke's shape: " + "; ".join(
        f"{k}: {v['batches']} batches ({v['matches']} matches), "
        f"{v['snapshots']} snapshots, late {v['late_left_dropped']}, "
        f"spill {v['spill']}" for k, v in c.items()))
    print(f"phase 15(d): public interval join P=8: {d['rows']} rows equal "
          f"to join.mode=host's, {d['checkpoints']} checkpoints equal card "
          f"vs CPU (bytes {d['checkpoint_bytes']}), "
          f"{d['events_per_s']:.0f} events/s (host mode "
          f"{d['host_mode_events_per_s']:.0f}), launches {d['launches']}")
    lat = e["window_fire_latency_ms"] or {}
    print(f"phase 15(e): Q7 {e['records']} bids: {e['windows']} windows "
          f"equal oracle_q7 ({e['rows']} rows), {e['events_per_s']:.0f} "
          f"events/s, window fire p50 {lat.get('p50')} p99 {lat.get('p99')}"
          f" ms, launches {e['launches']}")
    out = {"q8": a, "thrash_10m": b, "join_smoke": c, "public_api": d,
           "q7": e, "launches": launches}
    print("joins " + json.dumps(out, default=str))
    return out


# ---------------------------------------------------------------- phase 16

#: tools/cep_smoke.py's shape: steps of BATCH records, dense and churn key
#: spaces, slots a shard
CS_STEPS, CS_BATCH, CS_DENSE, CS_CHURN, CS_BUDGET = 12, 256, 40, 20_000, 256


def _cep_patterns():
    """16(b)'s patterns, by name: tools/cep_smoke.py's 3-stage within-50
    sequence under both skips and its always-alive churn pattern, the
    ``times(2, 3).consecutive()`` loop of tests/test_mesh_cep.py:121 and
    the two widest layouts (Q=29 with R=7 and with R=29)."""
    from flink_tpu_torch.cep.pattern import AfterMatchSkipStrategy as S
    from flink_tpu_torch.cep.pattern import Pattern

    def v(b):
        return np.asarray(b["v"])

    def seq3(skip):
        return (Pattern.begin("a", skip=skip).where(lambda b: v(b) % 3 == 0)
                .next("b").where(lambda b: v(b) % 3 == 1)
                .next("c").where(lambda b: v(b) % 3 == 2).within(50))

    return {
        "seq3_skip_past": seq3(S.SKIP_PAST_LAST_EVENT),
        "seq3_no_skip": seq3(S.NO_SKIP),
        "churn": (Pattern.begin("a", skip=S.SKIP_PAST_LAST_EVENT)
                  .next("b").where(lambda b: v(b) == 7)),
        "times_loop": (Pattern.begin("a", skip=S.NO_SKIP)
                       .where(lambda b: v(b) < 5).times(2, 3).consecutive()
                       .next("end").where(lambda b: v(b) >= 7).within(60)),
        "wide_q29_r7": (Pattern.begin("a", skip=S.NO_SKIP)
                        .where(lambda b: v(b) % 3 == 0)
                        .times(1, 3).consecutive()
                        .next("b").where(lambda b: v(b) % 3 == 1)
                        .times(1, 3).consecutive()
                        .next("c").where(lambda b: v(b) % 3 == 2)
                        .times(1, 2).consecutive().within(100)),
        "wide_q29_r29": (Pattern.begin("a", skip=S.NO_SKIP)
                         .where(lambda b: v(b) < 8)
                         .times(1, 30).consecutive()),
    }


def _cs_steps(seed: int, n_keys: int):
    """tools/cep_smoke.py's stream: (keys, values, timestamps, watermark)."""
    rng = np.random.default_rng(seed)
    ts, out = 0, []
    for _ in range(CS_STEPS):
        keys = rng.integers(0, n_keys, size=CS_BATCH).astype(np.int64)
        vals = rng.integers(0, 9, size=CS_BATCH).astype(np.int64)
        tss = ts + np.sort(rng.integers(0, 30, size=CS_BATCH)).astype(
            np.int64)
        ts += 25
        out.append((keys, vals, tss, ts - 5))
    return out


def _cep_smoke_run(case: str, device: str):
    """One engine at tools/cep_smoke.py's shape (P=8, 256 slots a shard;
    the churn case over 20k keys with a spill dir): its batches, its
    snapshot after the last step and the engine."""
    import tempfile

    from flink_tpu_torch.cep.mesh_engine import MeshCepEngine
    from flink_tpu_torch.core.records import RecordBatch

    churn = case == "churn"
    stream = _cs_steps(7 if case.startswith("seq3") else 11,
                       CS_CHURN if churn else CS_DENSE)
    out = []
    with tempfile.TemporaryDirectory(prefix="cep-smoke-") as td:
        eng = MeshCepEngine(_cep_patterns()[case], key_field="k",
                            num_shards=8, device=device,
                            capacity_per_shard=CS_BUDGET,
                            spill_dir=td if churn else None)
        for keys, vals, tss, wm in stream:
            out += eng.process_batch(RecordBatch.from_pydict(
                {"k": keys, "v": vals, "__key_id__": keys}, timestamps=tss))
            out += eng.on_watermark(wm)
        snap = eng.snapshot()
    return out, snap, eng


def cep_card_equals_cpu(torch, device: str) -> dict:
    """16(b): every case of :func:`_cep_patterns` on the card and on the
    CPU: every emitted batch in order, the spill counters,
    ``query_match_batch`` over the dense keys, every plane outside slot 0
    and the snapshot equal."""
    from flink_tpu_torch.benchmarks.joins import digest

    out = {}
    for case in _cep_patterns():
        reset_counts()
        card, card_snap, ce = _cep_smoke_run(case, device)
        launches = read_counts()
        cpu, cpu_snap, pe = _cep_smoke_run(case, "cpu")
        if [digest(b) for b in card] != [digest(b) for b in cpu]:
            raise AssertionError(f"phase 16(b) {case}: batches differ card "
                                 "vs CPU")
        if not card:
            raise AssertionError(f"phase 16(b) {case}: no match")
        diffs = _snap_diffs(card_snap, cpu_snap)
        if diffs:
            raise AssertionError(f"phase 16(b) {case}: snapshot differs at "
                                 f"{diffs[:5]}")
        for what, a_pl, b_pl in (("state", ce._planes, pe._planes),
                                 ("pending", ce._pend, pe._pend),
                                 ("match", ce._match_planes,
                                  pe._match_planes)):
            for a, b in zip(a_pl, b_pl):
                if a.shape != b.shape or a[:, 1:].cpu().numpy().tobytes() \
                        != b[:, 1:].numpy().tobytes():
                    raise AssertionError(f"phase 16(b) {case}: a {what} "
                                         "plane differs outside slot 0")
        q = np.arange(CS_DENSE, dtype=np.int64)
        if ce.query_match_batch(q) != pe.query_match_batch(q):
            raise AssertionError(f"phase 16(b) {case}: query_match_batch "
                                 "differs")
        sc = ce.spill_counters()
        if sc != pe.spill_counters():
            raise AssertionError(f"phase 16(b) {case}: spill counters {sc} "
                                 f"vs {pe.spill_counters()}")
        if case == "churn" and (sc["rows_evicted"] == 0
                                or sc["rows_reloaded"] == 0):
            raise AssertionError(f"phase 16(b): churn did not spill ({sc})")
        if device == "cuda" and launches["exchange_rank"] == 0:
            raise AssertionError(f"phase 16(b) {case}: the rank kernel "
                                 "never launched")
        lay = ce._layout
        out[case] = {"batches": len(card),
                     "matches": sum(len(b) for b in card),
                     "Q": lay.n_states, "R": lay.ring, "spill": sc,
                     "launches": launches}
    return out


def cep_oracle(records: int):
    """Every match of the bench row's stream, as a sorted list of
    ``(key, start_ts, end_ts)``: per key in stream order, consecutive
    events ``e_i, e_{i+1}`` with ``v_i % 3 == 0``, ``v_{i+1} % 3 == 1``
    and ``ts_{i+1} - ts_i <= WITHIN_MS`` (no two overlap under
    SKIP_PAST_LAST_EVENT: no event matches both stages)."""
    from flink_tpu_torch.benchmarks import cep

    parts = list(cep.stream(records))
    keys = np.concatenate([p[0] for p in parts])
    vals = np.concatenate([p[1] for p in parts])
    ts = np.concatenate([p[2] for p in parts])
    o = np.argsort(keys, kind="stable")
    k, v, t = keys[o], vals[o], ts[o]
    hit = ((k[1:] == k[:-1]) & (v[:-1] % 3 == 0) & (v[1:] % 3 == 1)
           & (t[1:] - t[:-1] <= cep.WITHIN_MS))
    i = np.nonzero(hit)[0]
    return sorted(zip(k[i].tolist(), t[i].tolist(), t[i + 1].tolist()))


def device_profile_per_call(fn, iters: int) -> dict:
    """Device time and device kernels per call of ``fn`` by torch.profiler
    over ``iters`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CUDA]
    return {"device_ms": sum(ev.time_range.elapsed_us() for ev in evs)
            / 1e3 / iters if evs else None,
            "kernels": len(evs) / iters if evs else None}


#: 16(a)'s records compared with the host backend (cut from the
#: benchmark's 1<<19 when phase 23 came, and to 1<<17 when phase 26 came:
#: the host backend runs ~15k events/s; every match of the run is held
#: to the NumPy oracle all the same)
CEP_CHECK_RECORDS = 1 << 17


def cep_bench(torch, records: int, device: str) -> dict:
    """16(a): ``benchmarks/cep.py``'s row on ``device``, every match of
    the run against :func:`cep_oracle`, the advance timed per fire in the
    run (wall ms, synchronised) and alone on one fire's inputs captured
    mid-run (CUDA events, device ms and kernels per call by
    torch.profiler, card == CPU on them); then the row's check against
    the host backend."""
    from flink_tpu_torch.benchmarks import cep
    from flink_tpu_torch.cep import kernels

    plain = kernels.cep_advance
    adv_ms, captured = [], {}
    # a fire a third into the run: steady state, spill engaged
    capture_at = records // cep.BATCH // 3

    def timed(planes, pending, slots, idx, wok, nev, tables, steps=None):
        if len(adv_ms) == capture_at:
            captured.update(
                planes=[x.clone() for x in planes],
                pending=[x.clone() for x in pending], slots=slots.clone(),
                idx=idx.clone(), wok=wok.clone(), nev=nev.clone(),
                tables=tables, steps=steps)
        t0 = time.perf_counter()
        out = plain(planes, pending, slots, idx, wok, nev, tables,
                    steps=steps)
        if device == "cuda":
            torch.cuda.synchronize()
        adv_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    got: list = []
    kernels.cep_advance = timed
    try:
        reset_counts()
        r = cep.run(records, device, matches_out=got, host_records=0)
    finally:
        kernels.cep_advance = plain
    r["check"] = cep.check(min(records, CEP_CHECK_RECORDS), device)
    r["launches"] = read_counts()
    if not r["check"]["equal_to_host_backend"]:
        raise AssertionError(
            f"phase 16(a): differs from the host backend at batch "
            f"{r['check']['first_divergent_batch']} of "
            f"{r['check']['batches_compared']}")
    want = cep_oracle(records)
    if sorted(got) != want or not want:
        raise AssertionError(f"phase 16(a): {len(got)} matches, the oracle "
                             f"{len(want)}; {len(set(got) ^ set(want))} "
                             "differ")
    sp = r["spill"]
    if sp["rows_evicted"] == 0 or sp["rows_reloaded"] == 0:
        raise AssertionError(f"phase 16(a): the page tier was not used ({sp})")
    if device == "cuda" and r["rank_launches"] != r["batches"]:
        raise AssertionError(
            f"phase 16(a): {r['rank_launches']} rank launches for "
            f"{r['batches']} ingest batches (one each expected)")
    srt = sorted(adv_ms)
    r["advance"] = {"calls": len(adv_ms),
                    "wall_ms_p50": srt[len(srt) // 2],
                    "wall_ms_p99": srt[min(len(srt) - 1,
                                           int(0.99 * len(srt)))],
                    "wall_s": sum(adv_ms) / 1e3}
    c = captured
    P, K, E = c["idx"].shape
    r["advance"]["captured"] = {"P": P, "K": K, "E": E, "steps": c["steps"],
                                "lanes": int((c["slots"] != 0).sum())}

    def call(dev):
        planes = [x.clone().to(dev) for x in c["planes"]]
        m, a = plain(planes, [x.to(dev) for x in c["pending"]],
                     c["slots"].to(dev), c["idx"].to(dev), c["wok"].to(dev),
                     c["nev"].to(dev), kernels.AdvanceTables.build(
                         c["tables"].layout, torch.device(dev)),
                     steps=c["steps"])
        return [m, a, *planes]

    cpu = [x.numpy() for x in call("cpu")]
    if device == "cuda":
        card = [x.cpu().numpy() for x in call("cuda")]
        if any(x.tobytes() != y.tobytes() for x, y in zip(card, cpu)):
            raise AssertionError("phase 16(a): the captured advance on the "
                                 "card differs from the CPU")
        args = ([x.clone() for x in c["planes"]], c["pending"], c["slots"],
                c["idx"], c["wok"], c["nev"], c["tables"])

        def fn():
            plain(*args, steps=c["steps"])

        r["advance"]["captured"].update(
            ms=cuda_ms(fn, 50), **device_profile_per_call(fn, 20))
    return r


def cep_checkpoint(torch, device: str, records: int = 1 << 19,
                   at: int = 11) -> dict:
    """16(c): the bench row's engine (P=8, 1<<14 slots a shard, spill to a
    temp dir) over ``records``: a snapshot on ``device`` after batch
    ``at``, restored into a fresh engine on ``device`` and into one on the
    CPU; both continuations equal the uninterrupted run's batches."""
    import pickle
    import tempfile

    from flink_tpu_torch.benchmarks import cep
    from flink_tpu_torch.benchmarks.joins import digest
    from flink_tpu_torch.core.records import (
        KEY_ID_FIELD,
        TIMESTAMP_FIELD,
        RecordBatch,
    )

    def feed(eng, part, sink):
        for keys, vals, ts in part:
            eng.process_batch(RecordBatch({KEY_ID_FIELD: keys, "v": vals,
                                           TIMESTAMP_FIELD: ts}))
            sink += [digest(b) for b in
                     eng.on_watermark(int(ts[-1]) + 1 - cep.WM_LAG_MS)]

    batches = list(cep.stream(records))
    with tempfile.TemporaryDirectory(prefix="cep-ckpt-") as td:
        whole: list = []
        eng = cep.make_engine(device, spill_dir=f"{td}/a")
        feed(eng, batches[:at + 1], whole)
        snap = eng.snapshot()
        cut = len(whole)
        feed(eng, batches[at + 1:], whole)
        out = {"snapshot_bytes": len(pickle.dumps(snap)),
               "spill_at_snapshot": snap["spill"], "restore_ms": {}}
        for dev in dict.fromkeys((device, "cpu")):
            e2 = cep.make_engine(dev, spill_dir=f"{td}/{dev}")
            t0 = time.perf_counter()
            e2.restore(snap)
            if dev == "cuda":
                torch.cuda.synchronize()
            out["restore_ms"][dev] = (time.perf_counter() - t0) * 1e3
            cont: list = []
            feed(e2, batches[at + 1:], cont)
            if cont != whole[cut:] or not cont:
                raise AssertionError(f"phase 16(c): the run restored on "
                                     f"{dev} differs from the uninterrupted"
                                     " one")
    out["batches_after_restore"] = len(whole) - cut
    return out


def _cep_source(records: int):
    """The bench row's stream as a source (key column ``k``), its
    position the batches emitted."""
    from flink_tpu_torch.benchmarks import cep
    from flink_tpu_torch.connectors.sources import CollectionSource
    from flink_tpu_torch.core.records import RecordBatch

    return CollectionSource([RecordBatch.from_pydict(
        {"k": keys, "v": vals}, timestamps=ts)
        for keys, vals, ts in cep.stream(records)])


def cep_public_api(torch, tmp: str, device: str,
                   records: int = 1 << 17) -> dict:
    """16(d): a ``Transformation`` whose factory is ``MeshCepOperator`` (as
    ``flink_tpu/table/planner.py:377-381`` builds one) through
    ``env.execute`` at ``parallelism.default=8`` with a checkpoint every 2
    source batches: its rows equal, in order, those of the same job
    through ``CEP.pattern(keyed, p).select()`` (the host operator)."""
    from flink_tpu_torch.benchmarks import cep
    from flink_tpu_torch.benchmarks.joins import digest
    from flink_tpu_torch.cep import CEP, MeshCepOperator
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.datastream.stream import DataStream
    from flink_tpu_torch.graph.transformations import Transformation

    def build(device_op):
        def job(env):
            keyed = env.from_source(_cep_source(records)).key_by("k")
            if not device_op:
                return CEP.pattern(keyed, cep.pattern()).select()
            return DataStream(env, Transformation(
                name="match_recognize", kind="one_input",
                operator_factory=lambda: MeshCepOperator(
                    cep.pattern(), key_field="k", capacity=cep.BUDGET),
                inputs=[keyed.transformation], keyed=True, key_field="k"))
        return job

    base = {"parallelism.default": 8, "execution.micro-batch.size": 1 << 15,
            "execution.checkpointing.every-n-source-batches": 2,
            "state.checkpoints.num-retained": 1000}
    sinks, results, walls = {}, {}, {}
    for tag, dev, device_op in (("device", device, True),
                                ("host", "cpu", False)):
        sinks[tag] = CollectSink()
        if tag == "device":
            reset_counts()
        results[tag], walls[tag] = _job(
            torch, build(device_op), dev,
            {**base, "state.checkpoints.dir": f"{tmp}/cep-{tag}"},
            sinks[tag])
        if tag == "device":
            launches = read_counts()
    got = [digest(b) for b in sinks["device"].batches]
    if not got or got != [digest(b) for b in sinks["host"].batches]:
        raise AssertionError("phase 16(d): MeshCepOperator's rows differ "
                             "from CEP.pattern().select()'s")
    ckpts = results["device"].metrics["checkpoints"]
    if not ckpts:
        raise AssertionError("phase 16(d): no checkpoint written")
    if device == "cuda" and launches["exchange_rank"] == 0:
        raise AssertionError("phase 16(d): the rank kernel never launched")
    return {"records": records,
            "rows": sum(len(b) for b in sinks["device"].batches),
            "checkpoints": len(ckpts),
            "checkpoint_bytes": [x["bytes"] for x in ckpts],
            "events_per_s": records / walls["device"],
            "host_operator_events_per_s": records / walls["host"],
            "launches": launches}


def phase_cep(torch, records: int = 4_000_000, device: str = "cuda") -> dict:
    """Phase 16: CEP on ``device`` (``"cpu"`` rehearses it on a host
    without a card; (b) and (c) then compare the CPU with itself)."""
    import tempfile

    if device == "cuda":
        from flink_tpu_torch.stateplane import cuda_build

        cuda_build.build_all()
    t0 = time.perf_counter()
    a = cep_bench(torch, records, device)
    b = cep_card_equals_cpu(torch, device)
    c = cep_checkpoint(torch, device)
    with tempfile.TemporaryDirectory(prefix="cep-") as tmp:
        d = cep_public_api(torch, tmp, device)
    launches = {k: a["launches"][k] + d["launches"][k]
                + sum(v["launches"][k] for v in b.values())
                for k in a["launches"]}
    lat, adv = a["emit_latency_ms"], a["advance"]
    where = card_line() if device == "cuda" else "cpu"
    print(f"phase 16(a) cep_patterns_10m_keys ({where}): "
          f"{a['events']} records at {a['events_per_s']:.0f} events/s, emit "
          f"latency p50 {lat['p50']:.2f} p99 {lat['p99']:.2f} ms over "
          f"{lat['count']} fires, {a['matches']} matches equal to the NumPy "
          f"oracle, first {a['check']['records']} records in "
          f"{a['check']['batches_compared']} batches equal to the host "
          f"backend ({a['check']['host_backend']['events_per_s']:.0f} "
          f"events/s), "
          f"spill {a['spill']}, {a['rank_launches']} rank launches for "
          f"{a['batches']} ingest batches (launches with the check's run "
          f"{a['launches']})")
    print(f"phase 16(a) advance: {adv['calls']} calls, wall p50 "
          f"{adv['wall_ms_p50']:.3f} p99 {adv['wall_ms_p99']:.3f} ms "
          f"(synchronised), {adv['wall_s']:.3f} s of {a['wall_s']:.3f} s; "
          f"captured fire {adv['captured']}")
    print("phase 16(b): card == CPU at cep_smoke's shapes: " + "; ".join(
        f"{k} (Q={v['Q']}, R={v['R']}): {v['batches']} batches "
        f"({v['matches']} matches), spill rows evicted "
        f"{v['spill']['rows_evicted']}" for k, v in b.items()))
    print(f"phase 16(c): snapshot of {c['snapshot_bytes']} B (spill "
          f"{c['spill_at_snapshot']}), restore ms {c['restore_ms']}, "
          f"{c['batches_after_restore']} batches after it equal the "
          f"uninterrupted run on {sorted(c['restore_ms'])}")
    print(f"phase 16(d): MeshCepOperator P=8 through env.execute: "
          f"{d['rows']} rows equal to CEP.pattern().select()'s, "
          f"{d['checkpoints']} checkpoints (bytes {d['checkpoint_bytes']}), "
          f"{d['events_per_s']:.0f} events/s (host operator "
          f"{d['host_operator_events_per_s']:.0f}), launches {d['launches']}")
    out = {"bench": a, "cep_smoke": b, "checkpoint": c, "public_api": d,
           "launches": launches, "seconds": time.perf_counter() - t0}
    print("cep " + json.dumps(out, default=str))
    return out


# --------------------------------------- phases 9(b) and 17: slice 11

class EngineRecorder:
    """Keeps every engine of class ``cls`` built while it is open (a job
    run through ``env.execute()`` hides its operators' engines)."""

    def __init__(self, cls):
        self.cls, self.engines, self._init = cls, [], cls.__init__
        rec = self

        def init(eng, *a, **k):
            rec._init(eng, *a, **k)
            rec.engines.append(eng)

        cls.__init__ = init

    def close(self):
        self.cls.__init__ = self._init


def _mesh_spill_run(torch, device, bids, budget, lag):
    """Fired batches, spill counters and hybrid fires of a float32 Sum over
    ``bids`` on ``MeshWindowEngine`` at P=8 under ``budget`` rows a shard,
    each batch's watermark ``lag`` ms behind its newest bid."""
    from flink_tpu_torch.core.records import KEY_ID_FIELD, RecordBatch
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.sharded_windower import MeshWindowEngine
    from flink_tpu_torch.windowing.aggregates import SumAggregate
    from flink_tpu_torch.windowing.assigners import SlidingEventTimeWindows

    eng = MeshWindowEngine(SlidingEventTimeWindows.of(SIZE, SLIDE),
                           SumAggregate("v"), make_mesh(8, device),
                           capacity_per_shard=budget,
                           max_device_slots=budget)
    fired = []
    for keys, vals, ts in bids:
        eng.process_batch(RecordBatch.from_pydict(
            {KEY_ID_FIELD: keys, "v": vals}, timestamps=ts))
        fired.extend(eng.on_watermark(int(ts.max()) - 1 - lag))
    fired.extend(eng.on_watermark(1 << 62))
    return fired, eng.spill_counters(), eng.hybrid_fires


def _batches_equal(what, got, want):
    """Fired batches equal in order, every column bit for bit; rows."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} fired batches on the "
                             f"card, {len(want)} on the CPU")
    rows = 0
    for g, w in zip(got, want):
        for name in w.columns:
            a, b = np.asarray(g[name]), np.asarray(w[name])
            if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                raise AssertionError(f"{what}: column {name} differs "
                                     "between the card and the CPU")
        rows += len(w)
    return rows


def phase_mesh_spill(torch, records: int = 3_000_000,
                     budget: int = 1 << 14, lag: int = 4_000):
    """Phase 9(b): phase 9's stream on the mesh window engine at P=8 under
    a per-shard budget, card == CPU bit for bit."""
    from flink_tpu_torch.benchmarks.nexmark import BidSource

    src = BidSource(total_records=records, num_auctions=AUCTIONS,
                    events_per_second_of_eventtime=RATE)
    src.open()
    rng = np.random.default_rng(3)
    bids = []
    while (b := src.poll_batch(1 << 18)) is not None:
        vals = _sum_specials(rng, rng.standard_normal(len(b))
                             .astype(np.float32))
        # each bid's event time moves back by up to `lag` ms: bids of
        # slices already spilled arrive again, so the tier reloads
        ts = (np.asarray(b.timestamps, dtype=np.int64)
              - rng.integers(0, lag, len(b)))
        bids.append((np.asarray(b["auction"], dtype=np.int64), vals, ts))
    reset_counts()
    t0 = time.perf_counter()
    card, card_counters, card_hybrid = _mesh_spill_run(torch, "cuda", bids,
                                                       budget, lag)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = read_counts()
    t0 = time.perf_counter()
    cpu, cpu_counters, cpu_hybrid = _mesh_spill_run(torch, "cpu", bids,
                                                    budget, lag)
    cpu_s = time.perf_counter() - t0
    rows = _batches_equal("phase 9(b)", card, cpu)
    if card_counters != cpu_counters or card_hybrid != cpu_hybrid:
        raise AssertionError(f"phase 9(b): spill counters differ: card "
                             f"{card_counters} ({card_hybrid} hybrid), CPU "
                             f"{cpu_counters} ({cpu_hybrid} hybrid)")
    if card_counters["rows_evicted"] <= 0 or \
            card_counters["rows_reloaded"] <= 0 or card_hybrid <= 0:
        raise AssertionError(f"phase 9(b): no eviction, reload or hybrid "
                             f"fire ({card_counters}, {card_hybrid})")
    if counts["exchange_rank"] <= 0 or counts["ordered_fold"] <= 0:
        raise AssertionError(f"phase 9(b): a kernel did not launch "
                             f"({counts})")
    out = {"records": records, "max_device_slots_per_shard": budget,
           "lag_ms": lag, "fired_batches": len(card), "rows": rows,
           "spill_counters": card_counters, "hybrid_fires": card_hybrid,
           "card_s": card_s, "cpu_s": cpu_s, "launches": counts}
    print(f"phase 9(b): forced eviction on the mesh engine at P=8 "
          f"({budget} rows a shard): {len(card)} fired batches, {rows} "
          f"rows equal on the card and the CPU bit for bit; spill counters "
          f"equal ({card_counters}); {card_hybrid} hybrid fires; launches "
          f"{counts}")
    print("mesh_spill " + json.dumps(out))
    return out


def phase_mesh_budget_q5(torch, records: int = 10_000_000,
                         budget: int = 1 << 16):
    """Phase 17(a): Q5 at P=8 through ``env.execute()`` under
    ``state.slot-table.max-device-slots`` a shard, against its oracle."""
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.nexmark import BidSource, build_q5
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.parallel.sharded_windower import MeshWindowEngine

    env = StreamExecutionEnvironment(Configuration({
        "parallelism.default": 8, "execution.micro-batch.size": 1 << 20,
        "execution.device": "cuda",
        "state.slot-table.max-device-slots": budget}))
    sink = CollectSink()
    build_q5(env, BidSource(total_records=records, num_auctions=AUCTIONS,
                            events_per_second_of_eventtime=RATE),
             size_ms=SIZE, slide_ms=SLIDE, device_top_k=TOP_K).sink_to(sink)
    rec = EngineRecorder(MeshWindowEngine)
    try:
        reset_counts()
        t0 = time.perf_counter()
        result = env.execute("q5-budget")
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = read_counts()
    finally:
        rec.close()
    eng = rec.engines[0]
    spill = eng.spill_counters()
    if counts["exchange_rank"] <= 0:
        raise AssertionError("phase 17(a): the rank kernel did not launch")
    if spill["rows_evicted"] <= 0:
        raise AssertionError(f"phase 17(a): no eviction ({spill})")
    got = {}
    for r in sink.rows():
        got.setdefault(r["window_end"], (r["count"], set()))[1].add(
            int(r["auction"]))
    want = q5_oracle_cached(records)
    if set(got) != set(want):
        raise AssertionError(f"phase 17(a): {len(got)} windows, oracle "
                             f"{len(want)}")
    for w, (best, winners) in want.items():
        g_best, g_winners = got[w]
        if g_best != best or not g_winners <= winners or \
                len(g_winners) != min(len(winners), TOP_K):
            raise AssertionError(f"phase 17(a): window {w} differs from "
                                 "the oracle")
    lat = result.metrics.get("window_fire_latency_ms", {})
    state_bytes = sum(a.numel() * a.element_size() for a in eng.accs)
    out = {"records": records, "max_device_slots_per_shard": budget,
           "elapsed_s": elapsed, "events_per_s": records / elapsed,
           "windows": len(got), "fire_latency_ms": lat,
           "spill_counters": spill, "hybrid_fires": eng.hybrid_fires,
           "state_bytes_on_card": state_bytes,
           "capacity_per_shard": eng.capacity, "launches": counts}
    print(f"phase 17(a): Q5 P=8 under {budget} rows a shard, {records} "
          f"records in {elapsed:.3f} s = {records / elapsed:.0f} events/s; "
          f"{len(got)} windows match the oracle; fire latency p50 "
          f"{lat.get('p50')} ms p99 {lat.get('p99')} ms; spill {spill}; "
          f"{eng.hybrid_fires} hybrid fires; state {state_bytes} B on the "
          f"card; launches {counts}")
    print("q5_budget " + json.dumps(out))
    return out


def _ns_sessions_run(torch, device, records, budget):
    """Phase 13(c)'s out-of-order float32 Max job on
    ``MeshSessionEngine(spill_layout="namespaces")`` at P=8: each batch's
    watermark 3,000 ms behind its newest record, as the executor's
    bounded-out-of-orderness strategy places it."""
    from flink_tpu_torch.connectors.sources import DataGenSource
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.sharded_sessions import MeshSessionEngine
    from flink_tpu_torch.runtime.operators import KeyByOperator
    from flink_tpu_torch.windowing.aggregates import MaxAggregate

    src = _jittered_specials(DataGenSource, 3_000)(records, 100_000,
                                                   400_000, seed=3)
    src.open()
    eng = MeshSessionEngine(2_000, MaxAggregate("value"), make_mesh(8, device),
                            capacity_per_shard=budget,
                            max_device_slots=budget,
                            spill_layout="namespaces")
    key_by, fired = KeyByOperator("key"), []
    while (b := src.poll_batch(1 << 13)) is not None:
        b = key_by.process_batch(b)[0]
        eng.process_batch(b)
        fired.extend(eng.on_watermark(int(b.timestamps.max()) - 3_001))
    fired.extend(eng.on_watermark(1 << 62))
    return fired, eng


def phase_mesh_sessions_ns(torch, records: int = 250_000,
                           budget: int = 1 << 11):
    """Phase 17(b): the namespace spill layout of the mesh session engine,
    card == CPU bit for bit."""
    reset_counts()
    t0 = time.perf_counter()
    card, ceng = _ns_sessions_run(torch, "cuda", records, budget)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = read_counts()
    cpu, peng = _ns_sessions_run(torch, "cpu", records, budget)
    rows = _batches_equal("phase 17(b)", card, cpu)
    spill = ceng.spill_counters()
    if spill != peng.spill_counters() or \
            ceng.merge_groups != peng.merge_groups:
        raise AssertionError(f"phase 17(b): spill counters or merges "
                             f"differ: card {spill}, CPU "
                             f"{peng.spill_counters()}")
    if spill["rows_evicted"] <= 0:
        raise AssertionError(f"phase 17(b): no eviction ({spill})")
    if counts["exchange_rank"] <= 0 or counts["ordered_fold"] <= 0:
        raise AssertionError(f"phase 17(b): a kernel did not launch "
                             f"({counts})")
    out = {"records": records, "max_device_slots_per_shard": budget,
           "rows": rows, "spill_counters": spill,
           "merge_groups": ceng.merge_groups, "card_s": card_s,
           "events_per_s": records / card_s, "launches": counts}
    print(f"phase 17(b): namespace-layout sessions at P=8 ({budget} rows a "
          f"shard), {records} records: {rows} rows equal on the card and "
          f"the CPU bit for bit; {ceng.merge_groups} merge groups; spill "
          f"{spill}; launches {counts}")
    print("mesh_sessions_ns " + json.dumps(out))
    return out


def phase_wordcount(torch, lines: int = 200_000):
    """Phase 17(c): BASELINE row 1 on the card."""
    from flink_tpu_torch.benchmarks import wordcount

    reset_counts()
    out = wordcount.run(lines, "cuda")
    out["launches"] = read_counts()
    if not out["oracle_ok"]:
        raise AssertionError(f"phase 17(c): counts {out['counts']} differ "
                             "from the oracle")
    if out["launches"]["ordered_fold"] <= 0:
        raise AssertionError("phase 17(c): the ordered fold did not launch")
    print(f"phase 17(c): BASELINE row 1 (socket WordCount, {lines} lines, "
          f"5 s processing-time windows): {out['value']:.0f} words/s; "
          f"per-word totals equal the oracle over {out['windows']} "
          f"windows; fire latency {out['fire_latency_ms']}; launches "
          f"{out['launches']} (P=1: no exchange; `.sum` keeps a float32 "
          f"leaf, folded by the ordered fold)")
    print("wordcount " + json.dumps(out))
    return out


def phase_batch_mode(torch):
    """Phase 17(d): ROADMAP Queue C item 11's job in batch mode, card ==
    CPU, key 0 window 0 = 44.0."""
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
    from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows

    rows = ([{"key": i % 2, "value": 1.0, "ts": 100 * i} for i in range(8)]
            + [{"key": 0, "value": 1.0, "ts": 5000}]
            + [{"key": 0, "value": 10.0, "ts": 150}] * 4)
    sinks, counts = {}, None
    for device in ("cuda", "cpu"):
        reset_counts()
        env = StreamExecutionEnvironment(Configuration({
            "execution.micro-batch.size": 9,
            "execution.runtime-mode": "batch",
            "parallelism.default": 8, "execution.device": device}))
        sinks[device] = CollectSink()
        env.from_collection(rows, timestamp_field="ts",
                            watermark_strategy=WatermarkStrategy
                            .for_bounded_out_of_orderness(0)) \
            .key_by("key").window(TumblingEventTimeWindows.of(1000)) \
            .sum("value").sink_to(sinks[device])
        env.execute("batch")
        counts = counts or read_counts()
    n = _rows_equal("phase 17(d)", sinks["cuda"], sinks["cpu"])
    k0 = [r["sum_value"] for r in sinks["cuda"].rows()
          if r["key"] == 0 and r["window_start"] == 0]
    if k0 != [44.0]:
        raise AssertionError(f"phase 17(d): key 0, window 0 = {k0}")
    if counts["exchange_rank"] <= 0:
        raise AssertionError("phase 17(d): the rank kernel did not launch")
    print(f"phase 17(d): batch mode at P=8, {n} rows equal on the card and "
          f"the CPU; key 0, window 0 = 44.0; launches {counts}")
    return {"rows": n, "launches": counts}


def phase_slice11(torch) -> dict:
    """Phases 9(b) and 17(a)-(d)."""
    return {"mesh_spill": phase_mesh_spill(torch),
            "q5_budget": phase_mesh_budget_q5(torch),
            "mesh_sessions_ns": phase_mesh_sessions_ns(torch),
            "wordcount": phase_wordcount(torch),
            "batch_mode": phase_batch_mode(torch)}


# ------------------------------------------------------------ phase 18


def _gate(where: str, failures) -> None:
    if failures:
        raise AssertionError(f"{where}: " + "; ".join(failures))


def _print_loss(tag: str, row: dict) -> None:
    parts = ", ".join(f"{k} {v:.2f}" for k, v in
                      row["recovery_parts_ms"].items())
    print(f"{tag}: {row['events']:,} events over {row['shards']} shards, "
          f"shard {row['dead']} lost at P={row['P_at_loss']} -> "
          f"P={row['P_after_loss']}: recovery "
          f"{row['shard_loss_recovery_ms']:.2f} ms ({parts}); "
          f"{row['survivor_rows']:,} survivor rows moved "
          f"({row['survivor_rows_resident']:,} resident, "
          f"{row['survivor_rows_spilled']:,} to pages); "
          f"{row['records_replayed']:,} records replayed (bound "
          f"{row['events'] // row['shards']:,}); {row['windows']:,} "
          f"committed windows equal the oracle; "
          f"{row['events_per_s']:,.0f} events/s over the chaotic run; "
          f"launches before the loss {row['launches_before_loss']}, "
          f"after {row['launches_after_loss']}")


def shard_loss_row7(torch) -> dict:
    """18(a): BASELINE row 7 at its own size on the card."""
    from flink_tpu_torch.benchmarks import shard_loss as sl

    row = sl.run("row7", "cuda")["row"]
    fails = list(row["failures"])
    if row["launches"]["exchange_rank"] <= 0 or \
            row["launches"]["ordered_fold"] <= 0:
        fails.append(f"a kernel did not launch ({row['launches']})")
    if row["launches_after_loss"]["exchange_rank"] <= 0:
        fails.append("the rank kernel did not launch after the loss")
    _gate("phase 18(a)", fails)
    _print_loss("phase 18(a)", row)
    print("shard_loss_row7 " + json.dumps(row))
    return row


#: 18(b)'s bids: 6 steps of 1<<20, cut from the benchmark's 10M to keep
#: the script's time (shard 3 is still lost at step 5's watermark)
SHARD_LOSS_Q5REV_RECORDS = 6_000_000


def shard_loss_q5rev(torch) -> dict:
    """18(b): Q5-revenue at P=8 through run_shard_loss_verify on the card;
    the rank kernel launches at D=8 before the loss and at D=7 after it."""
    from flink_tpu_torch.benchmarks import shard_loss as sl

    row = sl.run("q5rev", "cuda", records=SHARD_LOSS_Q5REV_RECORDS)["row"]
    fails = list(row["failures"])
    if (row["P_at_loss"], row["P_after_loss"]) != (8, 7):
        fails.append(f"mesh {row['P_at_loss']} -> {row['P_after_loss']}")
    if not row["launches_before_loss"]["exchange_rank"] or \
            row["launches_after_loss"]["exchange_rank"] <= 0:
        fails.append("the rank kernel did not launch at D=8 and at D=7 "
                     f"({row['launches_before_loss']}, "
                     f"{row['launches_after_loss']})")
    if row["launches"]["ordered_fold"] <= 0:
        fails.append("the ordered fold did not launch")
    _gate("phase 18(b)", fails)
    _print_loss("phase 18(b)", row)
    print("shard_loss_q5rev " + json.dumps(row))
    return row


def _reshard_run(device: str, steps, schedule) -> dict:
    """(b)'s job with live reshards in place of the loss, through
    run_crash_restore_verify with an empty fault plan."""
    import tempfile

    from flink_tpu_torch.benchmarks import shard_loss as sl
    from flink_tpu_torch.chaos.harness import run_crash_restore_verify
    from flink_tpu_torch.chaos.injection import FaultPlan

    make_engine, make_oracle = sl.q5rev_makers(device)
    seen = {}
    with tempfile.TemporaryDirectory(prefix="reshard-") as tmp:
        rep = run_crash_restore_verify(
            sl.watched(make_engine, seen), make_oracle, steps,
            FaultPlan(rules=[]), seed=sl.SEED,
            ckpt_root=os.path.join(tmp, "ckpt"), checkpoint_every=2,
            rescales=schedule)
    return {"report": rep, "engine": seen["engine"],
            "launches": sl.launches()}


def shard_loss_card_equals_cpu(torch, row7_keys: int = 60_000,
                               reshard_records: int = 1_000_000) -> dict:
    """18(c): (a)'s scenario at ``row7_keys`` keys, and (b)'s job over its
    first ``reshard_records`` bids in steps of 1<<18 with a live reshard
    8 -> 5 -> 8 in place of the loss, on the card and on the CPU: the
    committed windows, the report's signature and the final engine
    snapshot equal bit for bit."""
    from flink_tpu_torch.benchmarks import shard_loss as sl

    out = {}
    loss = {}
    for device in ("cuda", "cpu"):
        r = sl.run("row7", device, keys=row7_keys)
        _gate(f"phase 18(c) row 7 on {device}", r["row"]["failures"])
        loss[device] = r
    fails = []
    for what, got, want in (
            ("signature", loss["cuda"]["report"].signature(),
             loss["cpu"]["report"].signature()),
            ("committed windows", loss["cuda"]["report"].committed,
             loss["cpu"]["report"].committed)):
        if got != want:
            fails.append(f"row 7: {what} differ")
    diffs = _snap_diffs(loss["cuda"]["engine"].snapshot("savepoint"),
                        loss["cpu"]["engine"].snapshot("savepoint"))
    if diffs:
        fails.append(f"row 7: final snapshots differ at {diffs[:5]}")
    out["row7"] = {"keys": row7_keys,
                   "windows": loss["cuda"]["report"].windows,
                   "signature": loss["cuda"]["report"].signature(),
                   "launches": loss["cuda"]["row"]["launches"]}
    steps = sl.q5rev_steps(reshard_records, step=1 << 18)
    schedule = {1: 5, 3: 8}   # before steps 1 and 3 of the 4 at 1M bids
    rs = {d: _reshard_run(d, steps, schedule) for d in ("cuda", "cpu")}
    for what, got, want in (
            ("signature", rs["cuda"]["report"].signature(),
             rs["cpu"]["report"].signature()),
            ("committed windows", rs["cuda"]["report"].committed,
             rs["cpu"]["report"].committed)):
        if got != want:
            fails.append(f"reshard: {what} differ")
    diffs = _snap_diffs(rs["cuda"]["engine"].snapshot("savepoint"),
                        rs["cpu"]["engine"].snapshot("savepoint"))
    if diffs:
        fails.append(f"reshard: final snapshots differ at {diffs[:5]}")
    rep = rs["cuda"]["report"]
    if rep.live_handoffs != 2 or rep.diverged:
        fails.append(f"reshard: {rep.live_handoffs} handoffs, diverged "
                     f"{rep.diverged}")
    if rs["cuda"]["launches"]["exchange_rank"] <= 0 or \
            rs["cuda"]["launches"]["ordered_fold"] <= 0:
        fails.append(f"reshard: a kernel did not launch "
                     f"({rs['cuda']['launches']})")
    _gate("phase 18(c)", fails)
    out["reshard"] = {"records": reshard_records, "schedule": schedule,
                      "windows": rep.windows,
                      "signature": rep.signature(),
                      "last_reshard": rs["cuda"]["engine"].last_reshard,
                      "launches": rs["cuda"]["launches"]}
    launches = {k: out["row7"]["launches"][k] + out["reshard"]["launches"][k]
                for k in out["reshard"]["launches"]}
    print(f"phase 18(c): card == CPU bit for bit — row 7 at "
          f"{row7_keys:,} keys ({out['row7']['windows']:,} committed "
          f"windows, signature and final snapshot equal) and Q5-revenue "
          f"over {reshard_records:,} bids with a live reshard 8 -> 5 -> 8 "
          f"({rep.windows:,} windows, equal to the oracle; last reshard "
          f"{out['reshard']['last_reshard']}); launches {launches}")
    out["launches"] = launches
    return out


def watchdog_executor(torch, records: int = 3_000_000) -> dict:
    """18(d): Q5 at P=8 through env.execute() with watchdog.enabled: the
    rows equal the same job without it and sections were timed; with
    device.lost armed, execute() raises ShardFailedError naming the
    shard."""
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.nexmark import BidSource, build_q5
    from flink_tpu_torch.chaos import injection as chaos
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.runtime.watchdog import ShardFailedError

    def job(extra):
        env = StreamExecutionEnvironment(Configuration({
            "parallelism.default": 8, "execution.micro-batch.size": 1 << 20,
            "execution.device": "cuda", **extra}))
        sink = CollectSink()
        build_q5(env, BidSource(total_records=records,
                                num_auctions=AUCTIONS,
                                events_per_second_of_eventtime=RATE)
                 ).sink_to(sink)
        result = env.execute()
        torch.cuda.synchronize()
        return sink.rows(), result

    plain, _ = job({})
    reset_counts()
    rows, result = job({"watchdog.enabled": True})
    counts = read_counts()
    wd = result.metrics["watchdog"]
    fails = []
    if rows != plain:
        fails.append("rows differ from the job without the watchdog")
    if wd["sections_timed"] <= 0 or wd["declared_dead"] != 0:
        fails.append(f"watchdog counters {wd}")
    if counts["exchange_rank"] <= 0:
        fails.append("the rank kernel did not launch")
    plan = chaos.FaultPlan(rules=[chaos.FaultRule(
        pattern="device.lost", nth=2, where={"shard": 5})])
    raised = None
    with chaos.chaos_active(plan, 7):
        try:
            job({"watchdog.enabled": True})
        except ShardFailedError as e:
            raised = e
    if raised is None or raised.shard != 5 or "shard 5" not in str(raised):
        fails.append(f"device.lost did not leave execute() naming shard 5 "
                     f"({raised!r})")
    _gate("phase 18(d)", fails)
    print(f"phase 18(d): Q5 at P=8 with watchdog.enabled over {records:,} "
          f"bids: {len(rows):,} rows equal the job without it; watchdog "
          f"{wd}; with device.lost armed execute() raised "
          f"ShardFailedError: {raised}; launches {counts}")
    return {"rows": len(rows), "watchdog": wd, "launches": counts}


def _units_check(eng, fresh) -> tuple:
    """Each unit restored into ``fresh()`` with its key-group filter and
    merged, against the merge of the units themselves: (merged state,
    differing paths)."""
    units = eng.snapshot_sharded()
    restored = []
    for (g0, g1), unit in units.items():
        f = fresh()
        f.restore(unit, key_group_filter=range(g0, g1 + 1))
        restored.append(f.snapshot_sharded()[(g0, g1)])
    whole = eng.merge_unit_snapshots(list(units.values()))
    return whole, _snap_diffs(eng.merge_unit_snapshots(restored), whole)


def units_joins_cep(torch, join_records: int = 1 << 19,
                    cep_batches: int = 8) -> dict:
    """18(e): the engines of 15(a) (the Q8 join shape) and 16(a) (the CEP
    row) mid-run — after ``join_records`` records and ``cep_batches``
    batches — on the card and on the CPU: every shard unit restored into a
    fresh engine with its key-group filter and merged equals the merge of
    the units, and the union equals the full snapshot; card == CPU."""
    from flink_tpu_torch.benchmarks import cep as cb
    from flink_tpu_torch.benchmarks import joins as jb
    from flink_tpu_torch.core.records import (
        KEY_ID_FIELD,
        TIMESTAMP_FIELD,
        RecordBatch,
    )

    s = jb.SHAPES["q8"]
    got, fails, counts = {}, [], None
    for device in ("cuda", "cpu"):
        if device == "cuda":
            reset_counts()
        je = jb.make_engine("q8", device)
        jb.drive(je, join_records, s["num_keys"], s["rate"], s["band_ms"],
                 s["seed"])
        ce = cb.make_engine(device)
        for i, (keys, vals, ts) in enumerate(cb.stream(1 << 30)):
            if i == cep_batches:
                break
            ce.process_batch(RecordBatch({
                KEY_ID_FIELD: keys, "v": vals, TIMESTAMP_FIELD: ts}))
            ce.on_watermark(int(ts[-1]) + 1 - cb.WM_LAG_MS)
        if device == "cuda":
            torch.cuda.synchronize()
            counts = read_counts()
        jw, jd = _units_check(je, lambda: jb.make_engine("q8", device))
        cw, cd = _units_check(ce, lambda: cb.make_engine(device))
        full = je.snapshot()
        for side in ("left", "right"):
            if _snap_diffs(jw[side]["table"], full[side]["table"]):
                fails.append(f"join units on {device}: the {side} union "
                             "differs from the snapshot")
        # the CEP merge orders state rows by key, pending rows by
        # sequence and matches by rid
        full = ce.snapshot()
        for name, by in (("state", "key_id"), ("pending", "seq"),
                         ("matches", "rid")):
            order = np.argsort(np.asarray(full[name][by]), kind="stable")
            if _snap_diffs(cw[name], {col: np.asarray(v)[order]
                                      for col, v in full[name].items()}):
                fails.append(f"CEP units on {device}: the {name} union "
                             "differs from the snapshot")
        if cw["key_values"] != full["key_values"]:
            fails.append(f"CEP units on {device}: the key values' union "
                         "differs from the snapshot")
        if jd or cd:
            fails.append(f"units on {device}: restored merges differ at "
                         f"{(jd + cd)[:5]}")
        got[device] = (jw, cw)
    for name, i in (("join", 0), ("cep", 1)):
        d = _snap_diffs(got["cuda"][i], got["cpu"][i])
        if d:
            fails.append(f"{name} units: card != CPU at {d[:5]}")
    if counts["exchange_rank"] <= 0:
        fails.append("the rank kernel did not launch")
    _gate("phase 18(e)", fails)
    jn = sum(len(got["cuda"][0][s_]["table"].get("key_id", ()))
             for s_ in ("left", "right"))
    cn = len(got["cuda"][1]["state"]["key_id"])
    print(f"phase 18(e): join (Q8 shape, {join_records:,} records, "
          f"{jn:,} rows) and CEP ({cep_batches} batches, {cn:,} state "
          f"rows) shard units restored with key_group_filter and merged "
          f"equal the full snapshot, card == CPU bit for bit; launches "
          f"{counts}")
    return {"join_rows": jn, "cep_state_rows": cn, "launches": counts}


def phase_shard_loss(torch) -> dict:
    """Phase 18: shard-granular failure domains, (a)-(e)."""
    from flink_tpu_torch.stateplane import cuda_build

    cuda_build.build_all()
    t0 = time.perf_counter()
    parts = {"row7": shard_loss_row7(torch),
             "q5rev": shard_loss_q5rev(torch),
             "card_equals_cpu": shard_loss_card_equals_cpu(torch),
             "watchdog": watchdog_executor(torch),
             "units": units_joins_cep(torch)}
    launches = {k: sum(p["launches"][k] for p in parts.values())
                for k in ("exchange_rank", "ordered_fold")}
    print(f"phase 18: {time.perf_counter() - t0:.1f} s; launches "
          f"{launches}")
    return {**parts, "launches": launches,
            "seconds": time.perf_counter() - t0}

# ------------------------------------------------------------- phase 19


def _sync(torch, device):
    if device == "cuda":
        torch.cuda.synchronize()


#: 19(a)'s records in the async and CPU comparison runs
PROCESS_CHECK_RECORDS = 1_000_000


def process_job(torch, device: str = "cuda", shape=None,
                records: int = 2_000_000) -> dict:
    """19(a): the CountWithTimeout job (benchmarks/process_timeout.py) at
    its shape on the card — ``records`` cut from its 4M when phase 25 came
    (the script's time) —, the same job on the CPU and the async variant
    on the card: rows equal in emission order, and equal to the NumPy
    oracle; the two device states on the card."""
    from flink_tpu_torch.benchmarks import process_timeout as pt

    shape = shape or {"records": records,
                      **{k: pt.SHAPE[k] for k in ("keys", "batch")}}
    # the async and CPU comparison runs take the first 1M records
    cut = {**shape, "records": min(shape["records"], PROCESS_CHECK_RECORDS)}
    reset_counts()
    card = pt.run(device, **shape)
    _sync(torch, device)
    counts = read_counts()
    fails = []
    states = card["fn"].states
    if not all(st._dvals.device.type == device for st in states):
        fails.append(f"the device states are not on {device}")
    state_bytes = sum(st._dvals.numel() * st._dvals.element_size()
                      for st in states)
    asy = pt.run(device, use_async=True, **cut)
    cpu = pt.run("cpu", **cut)
    t0 = time.perf_counter()
    want = pt.oracle(**shape)
    oracle_s = time.perf_counter() - t0
    want_cut = want if cut == shape else pt.oracle(**cut)
    for name, out, rows in (("card", card, want), ("card async", asy,
                                                   want_cut),
                            ("CPU", cpu, want_cut)):
        if not pt.rows_equal(out["rows"], rows):
            fails.append(f"the {name} run's rows differ from the oracle")
    _gate("phase 19(a)", fails)
    row = {**pt.summary(card), "async": pt.summary(asy),
           "cpu": pt.summary(cpu), "state_bytes": state_bytes,
           "capacity": int(states[0]._dvals.numel()), "oracle_s": oracle_s,
           "launches": counts}
    print(f"phase 19(a): CountWithTimeout over {row['records']:,} records, "
          f"{row['rows']:,} rows equal to the oracle's in emission order "
          f"(the CPU's and the async run's over the first "
          f"{cut['records']:,} records too); "
          f"{row['events_per_s']:,.0f} events/s "
          f"(async {row['async']['events_per_s']:,.0f}, CPU "
          f"{row['cpu']['events_per_s']:,.0f}); fire p50 "
          f"{row['fire_p50_ms']:.2f} ms p99 {row['fire_p99_ms']:.2f} ms over "
          f"{row['fires']} fires; timers registered "
          f"{row['timers_registered']:,}, fired {row['timers_fired']:,}; "
          f"host s: timer heap {row['heap_s']:.3f}, state ops "
          f"{row['state_s']:.3f}; states {state_bytes:,} B on the card at "
          f"{row['capacity']:,} slots")
    print("process_timeout " + json.dumps(row))
    return row


def _revenue_changelog(device: str, tmp: str, bids: int) -> dict:
    """19(b)'s run on ``device``: Q5-revenue's bids folded by a
    ChangelogKeyedBackend (float32 Sum of the price per auction and 2 s
    slice), a checkpoint every 4 batches, a materialization every 8,
    namespaces older than the watermark's 10 s window freed."""
    from flink_tpu_torch.benchmarks.nexmark import BidSource
    from flink_tpu_torch.checkpoint.changelog import ChangelogKeyedBackend
    from flink_tpu_torch.windowing.aggregates import SumAggregate

    log_dir = os.path.join(tmp, f"changelog-{device}")
    b = ChangelogKeyedBackend(SumAggregate("price"), log_dir,
                              capacity=1 << 20, device=device)
    src = BidSource(total_records=bids, num_auctions=AUCTIONS,
                    events_per_second_of_eventtime=RATE)
    src.open()
    ckpts, live, ck_ms, mat = [], set(), [], []
    n = 0
    while (batch := src.poll_batch(1 << 16)) is not None:
        n += 1
        ns = batch.timestamps // SLIDE
        b.scatter(batch["auction"].astype(np.int64), ns.astype(np.int64),
                  (batch["price"],))
        live.update(np.unique(ns).tolist())
        wm = int(batch.timestamps.max()) - 1
        old = sorted(x for x in live if (x + 1) * SLIDE + SIZE <= wm)
        if old:
            b.free_namespaces(old)
            live.difference_update(old)
        if n % 8 == 0:
            t0 = time.perf_counter()
            m = b.materialize()
            mat.append({"seq": m["changelog_seq"],
                        "ms": (time.perf_counter() - t0) * 1e3,
                        "bytes": os.path.getsize(os.path.join(
                            log_dir,
                            f"materialized-{m['changelog_seq']}.npz"))})
        if n % 4 == 0:
            t0 = time.perf_counter()
            ck = b.checkpoint()
            ck_ms.append((time.perf_counter() - t0) * 1e3)
            ckpts.append((ck, _rows_by_key(
                b.table.snapshot(reset_dirty=False))))
    b.close()
    return {"log_dir": log_dir, "ckpts": ckpts, "ck_ms": ck_ms, "mat": mat,
            "batches": n}


def _rows_by_key(snap: dict) -> dict:
    """A SlotTable snapshot's columns in (namespace, key) order: a restore
    lands rows in other slots than the live table, whose frees left
    holes."""
    order = np.lexsort((snap["key_id"], snap["namespace"]))
    return {k: np.asarray(v)[order] for k, v in snap.items()}


def changelog_backend(torch, tmp: str, bids: int = 2_000_000,
                      device: str = "cuda") -> dict:
    """19(b): the changelog backend on the card against the CPU: the
    newest checkpoint and one before the last materialization restored
    into fresh backends, each snapshot equal bit for bit to the live
    table's at its cut and to the CPU's; a checkpoint truncated past its
    offset fails loudly; the ordered fold launched."""
    from flink_tpu_torch.checkpoint.changelog import ChangelogKeyedBackend
    from flink_tpu_torch.windowing.aggregates import SumAggregate

    reset_counts()
    card = _revenue_changelog(device, tmp, bids)
    _sync(torch, device)
    counts = read_counts()
    cpu = _revenue_changelog("cpu", os.path.join(tmp, "cpu"), bids)
    fails = []
    last_mat = card["mat"][-1]["seq"]
    picks = {"newest": len(card["ckpts"]) - 1,
             "before_last_materialization": max(
                 i for i, (ck, _) in enumerate(card["ckpts"])
                 if ck["changelog_seq"] < last_mat)}
    restore = {}
    for name, i in picks.items():
        for run, dev in ((card, device), (cpu, "cpu")):
            ck, live = run["ckpts"][i]
            fresh = ChangelogKeyedBackend(SumAggregate("price"),
                                          run["log_dir"], capacity=1 << 20,
                                          device=dev)
            fresh.restore(ck)
            got = _rows_by_key(fresh.table.snapshot(reset_dirty=False))
            if run is card:
                _sync(torch, dev)
                restore[name] = dict(fresh.restore_ms)
            fresh.close()
            d = _snap_diffs(got, live)
            if d:
                fails.append(f"{name} on {dev}: the restore differs "
                             f"from the live table at {d[:5]}")
        d = _snap_diffs(card["ckpts"][i][1], cpu["ckpts"][i][1])
        if d:
            fails.append(f"{name}: card != CPU at {d[:5]}")
    early = card["ckpts"][picks["before_last_materialization"]][0]
    fresh = ChangelogKeyedBackend(SumAggregate("price"), card["log_dir"],
                                  capacity=1 << 20, device=device)
    fresh.truncate_subsumed(last_mat)
    try:
        fresh.restore(early)
        fails.append("a checkpoint truncated past its offset restored")
    except RuntimeError as e:
        if "not restorable" not in str(e):
            raise
    fresh.close()
    if device == "cuda" and counts["ordered_fold"] <= 0:
        fails.append("the ordered fold did not launch")
    _gate("phase 19(b)", fails)
    rows = len(card["ckpts"][-1][1]["key_id"])
    row = {"bids": bids, "batches": card["batches"],
           "checkpoints": len(card["ckpts"]),
           "checkpoint_ms": card["ck_ms"],
           "materializations": card["mat"], "restore_ms": restore,
           "rows_at_newest": rows, "launches": counts}
    ck_ms = ", ".join("%.3f" % x for x in card["ck_ms"])
    mats = ", ".join("%.1f / %d" % (m["ms"], m["bytes"]) for m in card["mat"])
    print(f"phase 19(b): changelog backend over {bids:,} bids "
          f"({card['batches']} batches, {len(card['ckpts'])} checkpoints, "
          f"{len(card['mat'])} materializations): checkpoint ms (offset "
          f"only) {ck_ms}; materialize ms / bytes {mats}; restore ms "
          f"{restore}; {rows:,} rows at the newest cut equal the live table "
          f"and the CPU bit for bit; a truncated checkpoint refused; "
          f"launches {counts}")
    print("changelog " + json.dumps(row))
    return row


def _stop_after(records, control=None, request=None, after=0):
    """A BidSource that queues a control request as it hands out batch
    ``after``: the executor serves it once that batch went through the
    job."""
    from flink_tpu_torch.benchmarks.nexmark import BidSource

    class Queueing(BidSource):
        polled = 0

        def poll_batch(self, n):
            b = super().poll_batch(n)
            self.polled += 1
            if control is not None and self.polled == after:
                control.put(request)
            return b

    return Queueing(total_records=records, num_auctions=AUCTIONS,
                    events_per_second_of_eventtime=RATE)


def _q5_binary(torch, source, path, restore_from=None, control=None,
               device="cuda", batch=1 << 20):
    """Phase 5's Q5 at P=8 into a BinaryFileSink; returns the result and
    the launches. The source is polled inline (no pump thread), so that
    a request its batch ``after`` queues is served right after that
    batch."""
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.nexmark import build_q5
    from flink_tpu_torch.cluster.local_executor import LocalExecutor
    from flink_tpu_torch.connectors.sinks import BinaryFileSink

    env = StreamExecutionEnvironment(Configuration({
        "parallelism.default": 8, "execution.micro-batch.size": batch,
        "execution.pipeline.in-flight-batches": 0,
        "execution.device": device}))
    build_q5(env, source, size_ms=SIZE, slide_ms=SLIDE,
             device_top_k=TOP_K).sink_to(BinaryFileSink(path))
    reset_counts()
    t0 = time.perf_counter()
    result = LocalExecutor(env.config).run(
        env.get_stream_graph(), "q5-binary", restore_from=restore_from,
        control_queue=control)
    _sync(torch, device)
    return result, read_counts(), time.perf_counter() - t0


def _read_windows(*paths) -> dict:
    """{window_end: (count, set of auctions)} read back through
    BinaryFileSource."""
    from flink_tpu_torch.connectors.sources import BinaryFileSource

    out = {}
    for path in paths:
        src = BinaryFileSource(path)
        src.open()
        while (b := src.poll_batch(1 << 20)) is not None:
            for we, c, a in zip(b["window_end"].tolist(), b["count"].tolist(),
                                b["auction"].tolist()):
                if we in out and out[we][0] != c:
                    raise AssertionError(f"window {we} fired twice")
                out.setdefault(we, (c, set()))[1].add(a)
        src.close()
    return out


def stop_with_savepoint(torch, tmp: str, records: int = 10_000_000,
                        after: int = 5, device: str = "cuda",
                        batch: int = 1 << 20, keep: str = None) -> dict:
    """19(c): Q5 at P=8 into a BinaryFileSink, stopped with a savepoint
    after batch ``after`` and resumed from it to the end; both files read
    back through BinaryFileSource equal an uninterrupted run's windows
    (where a window's tied winners fit in k; beyond, both are k of them,
    as phase 5 checks); with drain=True every window up to the cut fires
    at the stop; the rank kernel launched before the stop and after the
    resume."""
    import queue

    from flink_tpu_torch.benchmarks.nexmark import BidSource
    from flink_tpu_torch.cluster.local_executor import SavepointRequest

    fails = []
    kw = {"device": device, "batch": batch}
    clean_path = os.path.join(tmp, "q5-clean.ftb")
    _, _, clean_s = _q5_binary(torch, _stop_after(records), clean_path,
                               **kw)
    clean = _read_windows(clean_path)
    parts, launches, secs = {}, {}, {}
    for drain in (False, True):
        tag = "drain" if drain else "stop"
        control = queue.Queue()
        sp = os.path.join(tmp, f"q5-sp-{tag}")
        req = SavepointRequest(sp, stop=True, drain=drain)
        p1 = os.path.join(tmp, f"q5-{tag}-1.ftb")
        result, before, secs[tag] = _q5_binary(
            torch, _stop_after(records, control, req, after), p1,
            control=control, **kw)
        path = req.wait(timeout=60)
        if result.metrics.get("savepoint") != path:
            fails.append(f"{tag}: the job did not stop at the savepoint")
        if keep is not None and not drain:   # 21(d) reads it
            shutil.copytree(path, keep)
        launches[tag] = {"before_stop": before}
        parts[tag] = [_read_windows(p1)]
        if not drain:
            p2 = os.path.join(tmp, "q5-stop-2.ftb")
            _, resumed, secs["resume"] = _q5_binary(
                torch, _stop_after(records), p2, restore_from=path, **kw)
            launches[tag]["after_resume"] = resumed
            parts[tag].append(_read_windows(p2))
    first, second = parts["stop"]
    if set(first) & set(second):
        fails.append("a window fired before the stop and after the resume")
    union = {**first, **second}
    want = q5_oracle_cached(records)
    tied = 0
    for w, (best, winners) in want.items():
        for name, got in (("stop + resume", union), ("uninterrupted", clean)):
            if w not in got:
                fails.append(f"{name}: window {w} missing")
                continue
            c, ws = got[w]
            if c != best or not ws <= winners or \
                    len(ws) != min(len(winners), TOP_K):
                fails.append(f"{name}: window {w} ({c}, {sorted(ws)[:3]})")
        if len(winners) <= TOP_K:
            if union.get(w) != clean.get(w):
                fails.append(f"window {w}: stop + resume != uninterrupted")
        else:
            tied += 1
    if set(union) != set(clean):
        fails.append(f"stop + resume fired {len(union)} windows, the "
                     f"uninterrupted run {len(clean)}")
    drained = parts["drain"][0]
    cut_ts = after * batch * 1000 // RATE   # the first timestamp not read
    for w in clean:
        if w - SIZE < cut_ts and w not in drained:
            fails.append(f"drain: window {w} (starts before the cut) did "
                         "not fire at the stop")
        if w <= cut_ts and drained.get(w) != clean[w] and \
                len(want[w][1]) <= TOP_K:
            fails.append(f"drain: window {w} differs from the "
                         "uninterrupted run")
    for tag, d in launches.items():
        for when, c in d.items():
            if device == "cuda" and c["exchange_rank"] <= 0:
                fails.append(f"{tag}: the rank kernel did not launch "
                             f"{when.replace('_', ' ')}")
    _gate("phase 19(c)", fails)
    row = {"records": records, "stop_after_batch": after,
           "windows": len(clean), "before_stop": len(first),
           "after_resume": len(second), "drained": len(drained),
           "windows_with_more_ties_than_k": tied, "seconds": secs,
           "launches": {
               k: sum(c[k] for d in launches.values() for c in d.values())
               for k in ("exchange_rank", "ordered_fold")},
           "launches_by_run": launches}
    print(f"phase 19(c): Q5 P=8 over {records:,} bids into a BinaryFileSink, "
          f"stopped with a savepoint after batch {after} ({len(first):,} "
          f"windows) and resumed ({len(second):,}): read back through "
          f"BinaryFileSource they equal the uninterrupted run's "
          f"{len(clean):,} windows ({tied} with more tied winners than k: "
          f"k of them each); drain fired {len(drained):,} windows at the "
          f"stop; launches {launches}; s {secs} (uninterrupted "
          f"{clean_s:.2f})")
    print("stop_with_savepoint " + json.dumps(row))
    return row


def async_waves(torch, device: str = "cuda", rounds: int = 2000) -> dict:
    """19(d): tools/bench_async_state.py's shape on a DeviceValueState
    (2,000 rounds x 16 ops x 64 keys, capacity 1<<16), sync and async, on
    the card and the CPU: the same reads, final state and kernel calls;
    and 200,000 puts into 1,000 slots equal to NumPy's a[s] = x on the
    card."""
    from flink_tpu_torch.benchmarks import async_state as bench
    from flink_tpu_torch.state.async_state import put_last_wins

    fails, rows = [], {}
    for label, dev in (("card", device), ("cpu", "cpu")):
        for mode in ("sync", "async"):
            rows[(label, mode)] = bench.run(dev, mode, rounds)
    ref = rows[("cpu", "sync")]
    for key, r in rows.items():
        if r["digest"] != ref["digest"] or not np.array_equal(
                r["final"].view(np.uint64), ref["final"].view(np.uint64)):
            fails.append(f"{key}: reads or final state differ")
    for mode in ("sync", "async"):
        if rows[("card", mode)]["kernel_calls"] != \
                rows[("cpu", mode)]["kernel_calls"]:
            fails.append(f"{mode}: kernel calls differ")
    rng = np.random.default_rng(11)
    s = rng.integers(0, 1000, 200_000)
    x = rng.normal(size=200_000).astype(np.float32)
    want = np.zeros(1000, dtype=np.float32)
    want[s] = x
    t = torch.zeros(1000, dtype=torch.float32, device=device)
    st, xt = torch.from_numpy(s).to(device), torch.from_numpy(x).to(device)
    put_last_wins(t, st, xt)
    if not np.array_equal(t.cpu().numpy().view(np.uint32),
                          want.view(np.uint32)):
        fails.append("the card's put with duplicates is not a[s] = x")
    put_ms = (cuda_ms(lambda: put_last_wins(t, st, xt), 50)
              if device == "cuda" else None)
    _gate("phase 19(d)", fails)
    row = {f"{label}_{m}": {k: v for k, v in r.items() if k != "final"}
           for (label, m), r in rows.items()}
    row["put_200k_into_1000_ms"] = put_ms
    row["launches"] = {"exchange_rank": 0, "ordered_fold": 0}
    print(f"phase 19(d): async waves on a DeviceValueState: card sync "
          f"{row['card_sync']['ops_per_s']:,.0f} ops/s, async "
          f"{row['card_async']['ops_per_s']:,.0f} ops/s "
          f"({row['card_async']['kernel_calls']} calls; CPU "
          f"{row['cpu_sync']['ops_per_s']:,.0f} / "
          f"{row['cpu_async']['ops_per_s']:,.0f}); reads, final state and "
          f"calls card == CPU; 200,000 puts into 1,000 slots == a[s] = x bit "
          f"for bit on the card ({put_ms} ms a call)")
    print("async_waves " + json.dumps(row))
    return row


def phase_process(torch, device: str = "cuda", small: bool = False,
                  keep_savepoint: str = None) -> dict:
    """Phase 19: process functions with device state, the changelog
    backend, stop-with-savepoint with the binary file sink, async waves.
    ``device="cpu", small=True`` rehearses it at a cut size without a
    card (the card-vs-CPU checks then compare the CPU with itself).
    ``keep_savepoint``: a directory to copy 19(c)'s stop savepoint to."""
    import tempfile

    if device == "cuda":
        from flink_tpu_torch.stateplane import cuda_build

        cuda_build.build_all()
    cut = ({"process": {"shape": {"records": 200_000, "keys": 200_000,
                                  "batch": 1 << 14}},
            "changelog": {"bids": 600_000},
            "stop": {"records": 600_000, "batch": 1 << 16},
            "async": {"rounds": 100}} if small else
           {"process": {}, "changelog": {}, "stop": {}, "async": {}})
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=".") as tmp:
        parts = {"process": process_job(torch, device, **cut["process"]),
                 "changelog": changelog_backend(torch, tmp, device=device,
                                                **cut["changelog"]),
                 "stop_with_savepoint": stop_with_savepoint(
                     torch, tmp, device=device, keep=keep_savepoint,
                     **cut["stop"]),
                 "async": async_waves(torch, device, **cut["async"])}
    launches = {k: sum(p["launches"][k] for p in parts.values())
                for k in ("exchange_rank", "ordered_fold")}
    print(f"phase 19: {time.perf_counter() - t0:.1f} s; launches "
          f"{launches}")
    return {**parts, "launches": launches,
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------- phase 20

ROW4_EVENTS, ROW4_KEYS, ROW4_PARTS = 8_000_000, 10_000, 4
ROW4_DDL = ("CREATE TABLE bench_bids (key BIGINT, value DOUBLE, "
            "ts BIGINT, WATERMARK FOR ts AS ts) "
            "WITH ('connector'='kafka', 'topic'='bench_bids', "
            "'broker'='bench')")
ROW4_SQL = """
    SELECT key, window_end, SUM(value) AS total
    FROM TABLE(HOP(TABLE bench_bids, DESCRIPTOR(ts),
                   INTERVAL '2' SECOND, INTERVAL '10' SECONDS))
    GROUP BY key, window_start, window_end
"""
TWO_LEVEL_SQL = ("SELECT cnt, COUNT(*) AS n, SUM(total) AS s FROM "
                 "(SELECT key, COUNT(*) AS cnt, SUM(value) AS total FROM t "
                 "GROUP BY key) GROUP BY cnt")
SQL_Q5_VIEW = ("CREATE VIEW AuctionBids AS SELECT auction, COUNT(*) AS num,"
               " window_start, window_end FROM TABLE(HOP(TABLE bid, "
               "DESCRIPTOR(ts), INTERVAL '2' SECOND, INTERVAL '10' SECOND)) "
               "GROUP BY auction, window_start, window_end")
SQL_Q5 = ("SELECT auction, num, window_end FROM (SELECT auction, num, "
          "window_end, ROW_NUMBER() OVER (PARTITION BY window_end ORDER BY "
          "num DESC) AS rownum FROM AuctionBids) WHERE rownum <= 1")


def _tenv(device, **cfg):
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.table import StreamTableEnvironment

    env = StreamExecutionEnvironment(Configuration(
        {"execution.device": device, **cfg}))
    return env, StreamTableEnvironment(env)


def row4_produce(total: int, chunk: int = 1 << 18) -> None:
    """``tools/bench_suite.py``'s row-4 topic on the port's FakeBroker
    ('bench', 4 partitions): keys over 10,000 and values from
    ``default_rng(1)``, 100,000 events/s of event time."""
    from flink_tpu_torch.connectors.kafka import FakeBroker
    from flink_tpu_torch.core.records import RecordBatch

    FakeBroker.reset()
    broker = FakeBroker.get("bench")
    broker.create_topic("bench_bids", ROW4_PARTS)
    rng = np.random.default_rng(1)
    produced = 0
    while produced < total:
        n = min(chunk, total - produced)
        ks = rng.integers(0, ROW4_KEYS, n).astype(np.int64)
        vs = rng.random(n)
        ts = (np.arange(produced, produced + n, dtype=np.int64)
              * 1000) // RATE
        for p in range(ROW4_PARTS):
            m = ks % ROW4_PARTS == p
            broker.append("bench_bids", p, RecordBatch.from_pydict(
                {"key": ks[m], "value": vs[m], "ts": ts[m]},
                timestamps=ts[m]))
        produced += n


def row4_job(torch, device: str):
    """Row 4's query over the produced topic, timed as the bench times it
    (``execute_sql(...).collect()``): (result batch, rows, seconds,
    launches, fire latency)."""
    env, tenv = _tenv(device, **{"execution.micro-batch.size": 1 << 16})
    tenv.execute_sql(ROW4_DDL)
    reset_counts()
    t0 = time.perf_counter()
    res = tenv.execute_sql(ROW4_SQL)
    rows = res.collect()
    _sync(torch, device)
    dt = time.perf_counter() - t0
    counts = read_counts()
    lat = env.last_execution_result.metrics.get("window_fire_latency_ms",
                                                {})
    return res.to_batch(), len(rows), dt, counts, lat


def row4_oracle(total: int):
    """(sums [windows, keys] float32, counts) of HOP(10 s, 2 s) SUM(value):
    per-(slice, key) float32 sums by np.add.at in the order the records
    arrive (a KafkaSource over the topic at the job's batch size — the
    order the CPU tests hold equal to the reference's), then each window's
    five slices folded left to right from 0, as the engine merges them."""
    from flink_tpu_torch.connectors.kafka import KafkaSource

    src = KafkaSource("bench_bids", broker_name="bench",
                      timestamp_field="ts")
    src.open(0, 1)
    k = SIZE // SLIDE
    n_slices = ((total - 1) * 1000 // RATE) // SLIDE + 1
    sums = np.zeros((n_slices + 2 * (k - 1), ROW4_KEYS), np.float32)
    counts = np.zeros(sums.shape, np.int64)
    flat_s, flat_c = sums.reshape(-1), counts.reshape(-1)
    while (b := src.poll_batch(1 << 16)) is not None:
        if not len(b):
            continue
        idx = ((b.timestamps // SLIDE) + (k - 1)) * ROW4_KEYS + b["key"]
        np.add.at(flat_s, idx, b["value"].astype(np.float32))
        flat_c += np.bincount(idx, minlength=flat_c.size)
    n_windows = n_slices + k - 1
    win = np.zeros((n_windows, ROW4_KEYS), np.float32)
    cnt = np.zeros((n_windows, ROW4_KEYS), np.int64)
    for j in range(k):
        win = win + sums[j:j + n_windows]
        cnt += counts[j:j + n_windows]
    return win, cnt


def row4_check(batch, total: int) -> int:
    """Every fired (key, window) sum equal to the stream-order oracle bit
    for bit, and exactly the oracle's (key, window) set; returns rows."""
    want, cnt = row4_oracle(total)
    e = np.asarray(batch["window_end"]) // SLIDE - 1
    key = np.asarray(batch["key"]).astype(np.int64)
    s = np.asarray(batch["total"])
    if s.dtype != np.float32:
        raise AssertionError(f"row 4: SUM came out {s.dtype}")
    if e.min() < 0 or e.max() >= len(want):
        raise AssertionError("row 4 fired a window the oracle lacks")
    pair = e * ROW4_KEYS + key
    present = cnt > 0
    if len(np.unique(pair)) != len(pair) or len(pair) != int(
            present.sum()) or not present.reshape(-1)[pair].all():
        raise AssertionError(f"row 4 fired {len(pair)} (key, window) rows, "
                             f"oracle {int(present.sum())}")
    bad = int((want[e, key].view(np.int32) != s.view(np.int32)).sum())
    if bad:
        raise AssertionError(f"row 4: {bad} of {len(s)} sums differ from "
                             "the stream-order oracle")
    return len(s)


def sql_row4(torch, events: int = ROW4_EVENTS, equal_events: int = 1_000_000,
             device: str = "cuda") -> dict:
    """20(a): BASELINE row 4 (``tools/bench_suite.py:136-190``)."""
    row4_produce(events)
    row4_job(torch, device)                       # warm
    batch, n_rows, dt, counts, lat = row4_job(torch, device)
    if device == "cuda" and counts["ordered_fold"] <= 0:
        raise AssertionError("row 4 ran without launching the ordered fold")
    t1 = time.perf_counter()
    checked = row4_check(batch, events)
    oracle_s = time.perf_counter() - t1
    row4_produce(equal_events)
    card, _, _, eq_counts, _ = row4_job(torch, device)
    cpu, _, _, _, _ = row4_job(torch, "cpu")
    _batches_equal("row 4 card vs CPU", [card], [cpu])
    row4_check(card, equal_events)
    launches = {k: counts[k] + eq_counts[k] for k in counts}
    out = {"events": events, "seconds": dt, "events_per_s": events / dt,
           "rows": n_rows, "rows_checked": checked,
           "fire_latency_ms": lat, "oracle_s": oracle_s,
           "equal_events": equal_events, "launches": launches}
    print(f"phase 20(a): row 4 (SQL HOP 10 s / 2 s SUM over a 4-partition "
          f"Kafka topic) {events} events in {dt:.3f} s = {events / dt:.0f} "
          f"events/s; fire p50 {lat.get('p50')} ms p99 {lat.get('p99')} ms; "
          f"all {checked} (key, window) sums equal the stream-order oracle "
          f"bit for bit; card == CPU bit for bit over {equal_events} events;"
          f" launches {launches}")
    return out


def _datagen_ddl(tenv, records: int, keys: int) -> None:
    tenv.execute_sql(
        "CREATE TABLE t (key BIGINT, value DOUBLE) WITH ("
        f"'connector'='datagen', 'number-of-rows'='{records}', "
        f"'number-of-keys'='{keys}', 'rows-per-second'='100000')")


def two_level_job(torch, device: str, records: int, keys: int,
                  changelog: bool = False):
    """20(b)'s query through the datagen connector: (materialized final
    rows, or the raw changelog in emission order; seconds; launches)."""
    env, tenv = _tenv(device, **{"execution.micro-batch.size": 1 << 16})
    _datagen_ddl(tenv, records, keys)
    reset_counts()
    t0 = time.perf_counter()
    out = (tenv.sql_query(TWO_LEVEL_SQL).stream.execute_and_collect()
           if changelog else tenv.execute_sql(TWO_LEVEL_SQL).to_batch())
    _sync(torch, device)
    return out, time.perf_counter() - t0, read_counts()


def two_level_oracle(records: int, keys: int):
    """{cnt: (keys with that count, float64 sum of their float32 values)}"""
    from flink_tpu_torch.connectors.sources import DataGenSource

    src = DataGenSource(total_records=records, num_keys=keys,
                        events_per_second_of_eventtime=100_000)
    src.open()
    count = np.zeros(keys, np.int64)
    total = np.zeros(keys, np.float64)
    while (b := src.poll_batch(1 << 20)) is not None:
        count += np.bincount(b["key"], minlength=keys)
        total += np.bincount(b["key"], weights=b["value"].astype(np.float64),
                             minlength=keys)
    live = count > 0
    n = np.bincount(count[live])
    s = np.bincount(count[live], weights=total[live])
    return {c: (int(n[c]), float(s[c])) for c in np.nonzero(n)[0].tolist()}


def sql_two_level(torch, records: int = 4_000_000, keys: int = 1_000_000,
                  equal_records: int = 1_000_000, device: str = "cuda"
                  ) -> dict:
    """20(b): the retraction path — a GROUP BY over an updating GROUP BY."""
    final, dt, counts = two_level_job(torch, device, records, keys)
    if device == "cuda" and counts["ordered_fold"] <= 0:
        raise AssertionError("20(b) ran without launching the ordered fold")
    want = two_level_oracle(records, keys)
    got = {int(c): (int(n), float(s)) for c, n, s in
           zip(final["cnt"], final["n"], final["s"])}
    if sorted(got) != sorted(want) or any(
            got[c][0] != want[c][0] for c in want):
        raise AssertionError(f"20(b): counts differ from the oracle: "
                             f"{sorted(got.items())[:4]} vs "
                             f"{sorted(want.items())[:4]}")
    rel = max(abs(got[c][1] - want[c][1]) / max(abs(want[c][1]), 1.0)
              for c in want)
    # float32 accumulators over ~records signed adds (every update
    # retracts the key's previous total and adds the new one)
    if rel > 1e-3:
        raise AssertionError(f"20(b): sums off the float64 oracle by {rel}")
    eq = {}
    for dev in (device, "cpu"):
        eq[dev] = (two_level_job(torch, dev, equal_records, keys),
                   two_level_job(torch, dev, equal_records, keys,
                                 changelog=True))
    _batches_equal("20(b) final rows card vs CPU", [eq[device][0][0]],
                   [eq["cpu"][0][0]])
    _batches_equal("20(b) changelog card vs CPU", [eq[device][1][0]],
                   [eq["cpu"][1][0]])
    ks_card, ks_counts = keyed_sum_job(torch, device, equal_records, keys)
    ks_cpu, _ = keyed_sum_job(torch, "cpu", equal_records, keys)
    _batches_equal("20(b) key_by().sum() card vs CPU", [ks_card], [ks_cpu])
    if device == "cuda" and ks_counts["ordered_fold"] <= 0:
        raise AssertionError("key_by().sum() ran without the ordered fold")
    launches = {k: counts[k] + eq[device][0][2][k] + eq[device][1][2][k]
                + ks_counts[k] for k in counts}
    out = {"records": records, "keys": keys, "seconds": dt,
           "events_per_s": records / dt, "groups": len(got),
           "max_rel_err_vs_f64_oracle": rel,
           "changelog_rows_equal": len(eq["cpu"][1][0]),
           "keyed_sum_rows_equal": len(ks_cpu), "launches": launches}
    print(f"phase 20(b): two-level SQL (count of counts with sums) over "
          f"{records} datagen records, {keys} keys, in {dt:.3f} s = "
          f"{records / dt:.0f} events/s; {len(got)} groups, counts equal the "
          f"oracle, sums within {rel:.3g} of the float64 oracle; over "
          f"{equal_records}: final rows and the {len(eq['cpu'][1][0])}-row "
          f"changelog card == CPU bit for bit in emission order, "
          f"key_by().sum() {len(ks_cpu)} rows card == CPU; launches "
          f"{launches}")
    return out


def keyed_sum_job(torch, device: str, records: int, keys: int):
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.connectors.sources import DataGenSource
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy

    env = StreamExecutionEnvironment(Configuration({
        "execution.device": device, "execution.micro-batch.size": 1 << 16}))
    src = DataGenSource(total_records=records, num_keys=keys,
                        events_per_second_of_eventtime=100_000)
    stream = env.from_source(
        src, WatermarkStrategy.for_bounded_out_of_orderness(0)) \
        .key_by("key").sum("value")
    reset_counts()
    out = stream.execute_and_collect()
    _sync(torch, device)
    return out, read_counts()


def sql_q5(torch, records: int = 10_000_000, parallelism: int = 8,
           device: str = "cuda") -> dict:
    """20(c): Top-N over HOP in SQL (the Q5 pattern) at P=8."""
    from flink_tpu_torch.benchmarks.nexmark import BidSource
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy

    env, tenv = _tenv(device, **{"parallelism.default": parallelism,
                                 "execution.micro-batch.size": 1 << 20})
    src = BidSource(total_records=records, num_auctions=AUCTIONS,
                    events_per_second_of_eventtime=RATE)
    tenv.create_temporary_view(
        "bid", env.from_source(
            src, WatermarkStrategy.for_bounded_out_of_orderness(0)),
        columns=["auction", "bidder", "price"], time_field="ts")
    tenv.execute_sql(SQL_Q5_VIEW)
    reset_counts()
    t0 = time.perf_counter()
    out = tenv.execute_sql(SQL_Q5).to_batch()
    _sync(torch, device)
    dt = time.perf_counter() - t0
    counts = read_counts()
    if device == "cuda" and parallelism > 1 and counts["exchange_rank"] <= 0:
        raise AssertionError("SQL Q5 ran without launching the rank kernel")
    want = q5_oracle_cached(records)
    got = {int(w): (int(n), int(a)) for w, n, a in
           zip(out["window_end"], out["num"], out["auction"])}
    if sorted(got) != sorted(want) or len(got) != len(out):
        raise AssertionError(f"SQL Q5: {len(out)} rows over {len(got)} "
                             f"windows, oracle {len(want)} windows")
    for w, (best, winners) in want.items():
        if got[w][0] != best or got[w][1] not in winners:
            raise AssertionError(f"SQL Q5 window {w}: got {got[w]}, oracle "
                                 f"({best}, {sorted(winners)[:5]}...)")
    res = {"records": records, "parallelism": parallelism, "seconds": dt,
           "events_per_s": records / dt, "windows": len(got),
           "launches": counts}
    print(f"phase 20(c): SQL Top-N over HOP (Q5) at P={parallelism}, "
          f"{records} bids in {dt:.3f} s = {records / dt:.0f} events/s; "
          f"each of {len(got)} windows' winner equals phase 5's oracle; "
          f"launches {counts}")
    return res


def sql_fold_cases(torch) -> dict:
    """20(d): the ordered fold's signed routes (``flat_scatter_signed``'s
    float leaves) against their plain version, bit for bit, timed at row
    4's batch (1<<16 lanes into ~60k live slots of a 1<<17 plane) and
    20(b)'s second level (~130k lanes of both signs into a few dozen
    slots), in float64 and in float32 (the leaf SQL SUM folds)."""
    clock = sm_clock_hz()
    rng = np.random.default_rng(20)
    shapes = {
        "row4": (1 << 17, 1 << 16,
                 lambda n: rng.integers(1, 60_001, n)),
        "second_level": (1 << 10, 130_000,
                         lambda n: np.minimum(rng.poisson(4.0, n), 40) + 1),
    }
    out = {}
    for shape, (cap, n, draw) in shapes.items():
        slots = torch.from_numpy(draw(n).astype(np.int32)).cuda()[None]
        signs = np.where(rng.random(n) < 0.5, -1.0, 1.0)
        for dt in (np.float64, np.float32):
            v = torch.from_numpy((rng.random(n) * signs).astype(dt)).cuda()
            name = f"{shape}_{np.dtype(dt).name}_signed"
            out[name] = fold_case(
                torch, name, torch.zeros(1, cap, dtype=v.dtype,
                                         device="cuda"),
                slots, v[None], clock, phase="20(d)")
    return out


def phase_sql(torch, device: str = "cuda", small: bool = False) -> dict:
    """Phase 20: SQL over Kafka (row 4), the retraction path, SQL Top-N
    at P=8 and the fold's signed routes. ``device="cpu", small=True``
    rehearses it at a cut size without a card (the card-vs-CPU checks
    then compare the CPU with itself, and 20(d) is skipped)."""
    if device == "cuda":
        from flink_tpu_torch.stateplane import cuda_build

        print(card_line())
        cuda_build.build_all()
    cut = ({"row4": {"events": 400_000, "equal_events": 200_000},
            "two": {"records": 300_000, "keys": 60_000,
                    "equal_records": 100_000},
            "q5": {"records": 600_000}} if small else
           {"row4": {}, "two": {}, "q5": {}})
    t0 = time.perf_counter()
    parts = {"row4": sql_row4(torch, device=device, **cut["row4"]),
             "two_level": sql_two_level(torch, device=device, **cut["two"]),
             "top_n": sql_q5(torch, device=device, **cut["q5"])}
    folds = sql_fold_cases(torch) if device == "cuda" else {}
    launches = {k: sum(p["launches"][k] for p in parts.values())
                for k in ("exchange_rank", "ordered_fold")}
    print(f"phase 20: {time.perf_counter() - t0:.1f} s; launches {launches}")
    print("sql " + json.dumps({**parts, "folds": folds}, default=str))
    return {**parts, "folds": folds, "launches": launches,
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------- phase 21

OVER_SPECS = [("SUM", "x", "__s__"), ("AVG", "x", "__a__"),
              ("MIN", "x", "__mn__"), ("MAX", "x", "__mx__")]
#: the reference's tolerance for the device OVER engine against the host
#: engine (tests/test_over_device.py:68-71), for SUM and AVG
OVER_RTOL, OVER_ATOL = 2e-4, 1e-5
ROW4_OVER_SQL = (
    "SELECT key, ts, SUM(value) OVER (PARTITION BY key ORDER BY ts RANGE "
    "BETWEEN INTERVAL '10' SECOND PRECEDING AND CURRENT ROW) AS s, "
    "COUNT(*) OVER (PARTITION BY key ORDER BY ts RANGE BETWEEN INTERVAL "
    "'10' SECOND PRECEDING AND CURRENT ROW) AS n FROM bench_bids")


def over_batches(rng, n_batches, rows, keys, wm=0):
    """``tools/bench_over.py``'s batches: sorted timestamps above the last
    watermark, ``keys`` uniform keys, normal values."""
    from flink_tpu_torch.core.records import (
        KEY_ID_FIELD,
        TIMESTAMP_FIELD,
        RecordBatch,
    )

    batches, wms = [], []
    for _ in range(n_batches):
        new_wm = wm + rows
        ts = np.sort(rng.integers(wm + 1, new_wm + 1, size=rows))
        batches.append(RecordBatch({
            KEY_ID_FIELD: rng.integers(0, keys, rows).astype(np.int64),
            "x": rng.normal(size=rows), TIMESTAMP_FIELD: ts.astype(np.int64)}))
        wms.append(new_wm)
        wm = new_wm
    return batches, wms


class _OverCtx:
    max_parallelism = 128

    def __init__(self, device):
        self.device = device


def over_bench_run(torch, engine: str, keys: int, device: str, timed: int,
                   warm: int = 3, rows: int = 50_000, preceding: int = 16,
                   profiled: int = 4) -> dict:
    """One engine over ``tools/bench_over.py``'s shape: ``warm`` fires,
    then ``timed`` fires timed on the wall clock (rows/s), then (device
    engine) ``profiled`` more fires under torch.profiler for the program's
    device ms and launches a fire. Returns the numbers and every fire's
    output."""
    from flink_tpu_torch.runtime.over_agg import OverAggOperator
    from flink_tpu_torch.runtime.over_device import DeviceOverAggOperator

    cls = DeviceOverAggOperator if engine == "device" else OverAggOperator
    op = cls("k", OVER_SPECS, mode="ROWS", preceding=preceding)
    op.open(_OverCtx(device))
    rng = np.random.default_rng(1)
    wb, wwm = over_batches(rng, warm, rows, keys)
    tb, twm = over_batches(rng, timed + profiled, rows, keys, wm=wwm[-1])
    outs = []
    for b, wm in zip(wb, wwm):
        op.process_batch(b)
        outs.extend(op.process_watermark(wm))
    _sync(torch, device)
    t0 = time.perf_counter()
    for b, wm in zip(tb[:timed], twm[:timed]):
        op.process_batch(b)
        outs.extend(op.process_watermark(wm))
    _sync(torch, device)
    dt = time.perf_counter() - t0
    row = {"engine": engine, "keys": keys, "timed_fires": timed,
           "rows_per_s": timed * rows / dt, "fire_ms": dt * 1e3 / timed}
    if engine == "device":
        row.update(over_device_profile(torch, op, tb[timed:], twm[timed:],
                                       device, outs))
        row["counters"] = op.counters()
    return row, outs


def over_device_profile(torch, op, batches, wms, device, outs) -> dict:
    """The device program's ms and launches a fire over ``batches``: CUDA
    kernel time and memcpy time by torch.profiler, kernels counted as
    launches; its share of the same fires' wall."""
    if device != "cuda" or not batches:
        for b, wm in zip(batches, wms):
            op.process_batch(b)
            outs.extend(op.process_watermark(wm))
        return {}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b, wm in zip(batches, wms):
            op.process_batch(b)
            outs.extend(op.process_watermark(wm))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern_us = copy_us = 0.0
    launches = 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        if "Memcpy" in ev.name or "Memset" in ev.name:
            copy_us += us
        else:
            kern_us += us
            launches += 1
    n = len(batches)
    return {"device_kernel_ms_per_fire": kern_us / 1e3 / n,
            "device_copy_ms_per_fire": copy_us / 1e3 / n,
            "launches_per_fire": launches / n,
            "profiled_fire_wall_ms": wall * 1e3 / n,
            "device_share_of_fire_wall":
                (kern_us + copy_us) / 1e3 / (wall * 1e3) if wall else None}


def _over_equal(what, host_outs, dev_outs) -> float:
    """The device engine's fires against the host engine's: keys,
    timestamps, values and MIN/MAX exactly, SUM/AVG to the reference's
    tolerance; returns the largest SUM/AVG error."""
    from flink_tpu_torch.core.records import KEY_ID_FIELD

    if len(host_outs) > len(dev_outs):
        raise AssertionError(f"{what}: {len(dev_outs)} device fires, "
                             f"{len(host_outs)} host fires")
    worst = 0.0
    for i, (h, d) in enumerate(zip(host_outs, dev_outs)):
        if len(h) != len(d):
            raise AssertionError(f"{what} fire {i}: {len(d)} rows, host "
                                 f"{len(h)}")
        for c in (KEY_ID_FIELD, "x"):
            if not np.array_equal(np.asarray(h[c]), np.asarray(d[c])):
                raise AssertionError(f"{what} fire {i}: column {c} differs")
        if not np.array_equal(h.timestamps, d.timestamps):
            raise AssertionError(f"{what} fire {i}: timestamps differ")
        for func, _, name in OVER_SPECS:
            a, b = np.asarray(d[name]), np.asarray(h[name])
            if func in ("MIN", "MAX"):
                if not np.array_equal(a, b):
                    raise AssertionError(f"{what} fire {i}: {func} differs")
                continue
            err = np.abs(a - b)
            if (err > OVER_ATOL + OVER_RTOL * np.abs(b)).any():
                raise AssertionError(f"{what} fire {i}: {func} off by "
                                     f"{err.max()}")
            worst = max(worst, float(err.max(initial=0.0)))
    return worst


def over_bench(torch, device: str = "cuda", timed: int = 20,
               host_timed_at_50k: int = 2, key_counts=(100, 2_000, 50_000)
               ) -> dict:
    """21(a), first half: both engines at ``tools/bench_over.py``'s shape
    (ROWS 16 PRECEDING, SUM/AVG/MIN/MAX, batches of 50,000 rows, 3 warm
    fires, then 20 timed) at 100, 2,000 and 50,000 keys. The host engine
    at 50,000 keys (its per-key loop: ~2.8 s a fire on a CPU) times only
    ``host_timed_at_50k`` fires; the device rows are held to the host rows
    over every fire both ran."""
    rows, fails = {}, []
    for keys in key_counts:
        h_timed = host_timed_at_50k if keys >= 50_000 else timed
        host, h_outs = over_bench_run(torch, "host", keys, device, h_timed,
                                      profiled=0)
        dev, d_outs = over_bench_run(torch, "device", keys, device, timed)
        dev["max_abs_err_sum_avg"] = _over_equal(
            f"21(a) {keys} keys", h_outs, d_outs)
        dev["fires_compared"] = len(h_outs)
        if dev["counters"]["over_degrades"] != 0:
            fails.append(f"{keys} keys: {dev['counters']} degrades")
        if device == "cuda" and dev["counters"]["over_device_fires"] < timed:
            fails.append(f"{keys} keys: the device program did not run")
        dev["speedup_vs_host"] = dev["rows_per_s"] / host["rows_per_s"]
        rows[keys] = {"host": host, "device": dev}
        print(f"phase 21(a) OVER ROWS 16 at {keys:,} keys: host "
              f"{host['rows_per_s']:,.0f} rows/s ({h_timed} fires), device "
              f"{dev['rows_per_s']:,.0f} rows/s; device program "
              f"{dev.get('device_kernel_ms_per_fire')} ms kernels + "
              f"{dev.get('device_copy_ms_per_fire')} ms copies, "
              f"{dev.get('launches_per_fire')} launches a fire, "
              f"{dev.get('device_share_of_fire_wall')} of the fire's wall; "
              f"{dev['fires_compared']} fires == host (SUM/AVG within "
              f"{dev['max_abs_err_sum_avg']:.3g}), degrades "
              f"{dev['counters']['over_degrades']}")
    _gate("phase 21(a)", fails)
    return rows


def over_oracle(keys, ts, vals, preceding: int):
    """Per-(key, ts) RANGE frame sums (float64) and counts over the whole
    stream: frames [ts - preceding, ts] with rowtime peers."""
    order = np.lexsort((ts, keys))
    k, t, v = keys[order], ts[order], vals[order].astype(np.float64)
    g = k * (np.int64(1) << 42) + t
    ends = np.searchsorted(g, g, side="right")
    starts = np.searchsorted(g, g - preceding, side="left")
    cs = np.r_[0.0, np.cumsum(v)]
    return k, t, cs[ends] - cs[starts], ends - starts


def row4_over_sql(torch, device: str = "cuda", events: int = 2_000_000
                  ) -> dict:
    """21(a), second half: row 4's stream (4 partitions, 10,000 keys,
    100,000 events/s) cut to ``events``, through SQL SUM and COUNT OVER a
    RANGE 10 s frame on the device engine (about 1M context rows live);
    every output row against a float64 NumPy oracle: counts exactly, sums
    to the reference's tolerance."""
    row4_produce(events)
    env, tenv = _tenv(device, **{"execution.micro-batch.size": 1 << 16,
                                 "table.exec.over.engine": "device"})
    tenv.execute_sql(ROW4_DDL)
    reset_counts()
    t0 = time.perf_counter()
    out = tenv.execute_sql(ROW4_OVER_SQL).to_batch()
    _sync(torch, device)
    dt = time.perf_counter() - t0
    per_op = env.last_execution_result.metrics["per_operator"]
    counters = [v for k, v in per_op.items()
                if k.startswith("sql_over_agg")][0]
    fails = []
    if counters["over_degrades"] or counters["over_host_fires"] or \
            counters["over_late_records_dropped"]:
        fails.append(f"counters {counters}")
    if len(out) != events:
        fails.append(f"{len(out)} rows out of {events}")
    # the oracle over the produced stream (row4_produce's draws)
    ks, vs = _row4_draws(events)
    ts = (np.arange(events, dtype=np.int64) * 1000) // RATE
    k, t, want_s, want_n = over_oracle(ks, ts, vs, 10_000)
    o = np.lexsort((np.asarray(out["ts"]), np.asarray(out["key"])))
    got_k = np.asarray(out["key"])[o]
    got_t = np.asarray(out["ts"])[o]
    got_s = np.asarray(out["s"], dtype=np.float64)[o]
    got_n = np.asarray(out["n"])[o]
    if not (np.array_equal(got_k, k) and np.array_equal(got_t, t)):
        fails.append("the (key, ts) rows differ from the stream's")
    elif not np.array_equal(got_n, want_n):
        fails.append(f"{int((got_n != want_n).sum())} counts differ")
    err = np.abs(got_s - want_s) if len(got_s) == len(want_s) else None
    if err is not None and (err > OVER_ATOL + OVER_RTOL
                            * np.abs(want_s)).any():
        fails.append(f"sums off the float64 oracle by {err.max()}")
    _gate("phase 21(a) SQL", fails)
    row = {"events": events, "seconds": dt, "events_per_s": events / dt,
           "counters": counters, "max_abs_err_sum": float(err.max()),
           "launches": read_counts()}
    print(f"phase 21(a) SQL: row 4's stream, {events:,} events, SUM and "
          f"COUNT OVER RANGE 10 s on the device engine in {dt:.3f} s = "
          f"{events / dt:,.0f} events/s; every row against the float64 "
          f"oracle (counts exact, sums within {row['max_abs_err_sum']:.3g});"
          f" counters {counters}")
    return row


def _row4_draws(events: int, chunk: int = 1 << 18):
    """The keys and values ``row4_produce`` draws, chunk by chunk."""
    rng = np.random.default_rng(1)
    ks, vs = [], []
    done = 0
    while done < events:
        n = min(chunk, events - done)
        ks.append(rng.integers(0, ROW4_KEYS, n).astype(np.int64))
        vs.append(rng.random(n))
        done += n
    return np.concatenate(ks), np.concatenate(vs)


def _auction_categories(num_auctions: int = AUCTIONS):
    return np.random.default_rng(21).integers(0, 10, num_auctions)


def lookup_fs_job(torch, device, tmp, bids, fail_after=None, restore=False,
                  batch=1 << 17):
    """21(b)'s job: bids enriched with their auction's category by a
    lookup join (LRU cache on), HOP(2 s, 10 s) SUM(price) GROUP BY
    auction, category at P=8, INSERT INTO a 'filesystem' table,
    checkpointing every 4 batches."""
    from flink_tpu_torch.benchmarks.nexmark import BidSource
    from flink_tpu_torch.connectors.lookup import TableLookupFunction
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy

    env, tenv = _tenv(device, **{
        "parallelism.default": 8, "execution.micro-batch.size": batch,
        "state.checkpoints.dir": os.path.join(tmp, "ck"),
        "execution.checkpointing.every-n-source-batches": 4})
    src = BidSource(total_records=bids, num_auctions=AUCTIONS,
                    events_per_second_of_eventtime=RATE)
    stream = env.from_source(
        src, WatermarkStrategy.for_bounded_out_of_orderness(0))
    fail = FailingMap(fail_after) if fail_after else (lambda b: b)
    stream = stream.map(lambda b: fail(b.with_column("ts", b.timestamps)),
                        name="fail")
    tenv.create_temporary_view("bid", stream,
                               columns=["auction", "bidder", "price", "ts"],
                               time_field="ts")
    cats = _auction_categories()
    tenv.create_lookup_table(
        "auctions", TableLookupFunction(
            [{"id": i, "category": int(c)} for i, c in enumerate(cats)],
            key_column="id"), ["id", "category"], cache_size=1 << 17)
    path = os.path.join(tmp, "out")
    tenv.execute_sql(
        "CREATE TABLE revenue (auction BIGINT, category BIGINT, window_end "
        f"BIGINT, total DOUBLE) WITH ('connector'='filesystem', 'path'="
        f"'{path}', 'format'='json')")
    tenv.execute_sql(
        "CREATE VIEW enriched AS SELECT b.auction, b.price, b.ts, "
        "a.category FROM bid AS b JOIN auctions FOR SYSTEM_TIME AS OF b.ts "
        "AS a ON b.auction = a.id")
    reset_counts()
    t0 = time.perf_counter()
    result = err = None
    if restore:   # how a user resumes a SQL job from its checkpoints
        os.environ["FLINK_TPU_RESTORE_FROM"] = os.path.join(tmp, "ck")
    try:
        result = tenv.execute_sql(
            "INSERT INTO revenue SELECT auction, category, window_end, "
            "SUM(price) AS total FROM TABLE(HOP(TABLE enriched, "
            "DESCRIPTOR(ts), INTERVAL '2' SECOND, INTERVAL '10' SECOND)) "
            "GROUP BY auction, category, window_start, window_end")
    except RuntimeError as e:
        if "injected failure" not in str(e):
            raise
        err = e
    finally:
        os.environ.pop("FLINK_TPU_RESTORE_FROM", None)
    _sync(torch, device)
    return result, path, time.perf_counter() - t0, read_counts(), err


def lookup_fs_exactly_once(torch, device: str = "cuda",
                           bids: int = 2_000_000, batch: int = 1 << 17
                           ) -> dict:
    """21(b): the lookup join into a filesystem table, exactly once at
    P=8. The first run fails after checkpoint 2 (a map in front of the
    join raises past 9 batches); a fresh job resumes from the checkpoints.
    The committed files hold each (auction, window) exactly once, with the
    auction's category, and every sum equals the stream-order float32
    oracle (phase 6's) bit for bit."""
    import tempfile

    from flink_tpu_torch.benchmarks.nexmark import BidSource
    from flink_tpu_torch.connectors.filesystem import read_committed_rows

    fails = []
    with tempfile.TemporaryDirectory(dir=".") as tmp:
        _, path, s1, c1, err = lookup_fs_job(
            torch, device, tmp, bids, fail_after=9 * batch, batch=batch)
        if err is None:
            fails.append("the first run did not fail")
        parts_at_crash = len([f for f in os.listdir(path)
                              if not f.endswith(".inprogress")])
        result, _, s2, c2, _ = lookup_fs_job(torch, device, tmp, bids,
                                             restore=True, batch=batch)
        t1 = time.perf_counter()
        raw = read_committed_rows(path)
        parts = len([f for f in os.listdir(path)
                     if not f.endswith(".inprogress")])
        rows = [json.loads(r) for r in raw]
        read_s = time.perf_counter() - t1
    metrics = result.metrics
    lookup = [v for k, v in metrics["per_operator"].items()
              if k.startswith("sql_lookup_join")][0]
    want, cnt = revenue_oracle_cached(bids)
    cats = _auction_categories()
    a = np.asarray([r["auction"] for r in rows], np.int64)
    e = np.asarray([r["window_end"] for r in rows], np.int64) // SLIDE - 1
    c = np.asarray([r["category"] for r in rows], np.int64)
    s = np.asarray([r["total"] for r in rows], np.float64).astype(np.float32)
    pair = e * AUCTIONS + a
    present = cnt > 0
    if len(np.unique(pair)) != len(pair):
        fails.append(f"{len(pair) - len(np.unique(pair))} (auction, window)"
                     " rows committed more than once")
    if len(pair) != int(present.sum()) or not present.reshape(-1)[pair].all():
        fails.append(f"{len(pair)} rows committed, oracle "
                     f"{int(present.sum())}")
    if not np.array_equal(c, cats[a]):
        fails.append("a row carries another auction's category")
    bad = int((want[e, a].view(np.int32) != s.view(np.int32)).sum())
    if bad:
        fails.append(f"{bad} of {len(s)} sums differ from the float32 "
                     "stream-order oracle")
    if device == "cuda":
        for k in ("exchange_rank", "ordered_fold"):
            if c1[k] + c2[k] <= 0:
                fails.append(f"{k} did not launch")
    _gate("phase 21(b)", fails)
    looked = lookup["cache_hits"] + lookup["cache_misses"]
    row = {"bids": bids, "batch": batch, "first_run_s": s1,
           "resumed_run_s": s2, "events_per_s": bids / (s1 + s2),
           "rows": len(rows), "part_files": parts,
           "part_files_at_crash": parts_at_crash,
           "restore_ms": metrics.get("restore_ms"),
           "cache_hit_rate_resumed_run": lookup["cache_hits"] / looked
           if looked else None, "lookup_counters_resumed_run": lookup,
           "read_back_s": read_s,
           "launches": {k: c1[k] + c2[k] for k in c1}}
    print(f"phase 21(b): lookup join + HOP SUM at P=8 INSERT INTO a "
          f"filesystem table, {bids:,} bids: failed after checkpoint 2 "
          f"({s1:.2f} s, {parts_at_crash} parts committed), resumed in "
          f"{s2:.2f} s (restore {row['restore_ms']} ms) = "
          f"{row['events_per_s']:,.0f} events/s over both; {len(rows):,} "
          f"(auction, window) rows committed once each in {parts} parts, "
          f"every sum == the float32 oracle bit for bit; cache hit rate "
          f"{row['cache_hit_rate_resumed_run']}; launches {row['launches']}")
    return row


def explain_plans(torch, device: str = "cuda") -> dict:
    """21(c): the EXPLAIN text of row 4's query, of 20(c)'s SQL Q5 at P=8
    and of 21(a)'s OVER query."""
    from flink_tpu_torch.benchmarks.nexmark import BidSource
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy

    out = {}
    _, tenv = _tenv(device)
    tenv.execute_sql(ROW4_DDL)
    out["row4"] = tenv.explain_sql(ROW4_SQL)
    out["over"] = tenv.explain_sql(ROW4_OVER_SQL)
    env, tenv = _tenv(device, **{"parallelism.default": 8})
    tenv.create_temporary_view(
        "bid", env.from_source(
            BidSource(total_records=1000, num_auctions=AUCTIONS),
            WatermarkStrategy.for_bounded_out_of_orderness(0)),
        columns=["auction", "bidder", "price"], time_field="ts")
    tenv.execute_sql(SQL_Q5_VIEW)
    out["q5_p8"] = tenv.execute_sql("EXPLAIN " + SQL_Q5)
    for name, text in out.items():
        if "== Physical Plan (chained job graph) ==" not in text:
            raise AssertionError(f"21(c): no physical plan for {name}")
        print(f"phase 21(c) EXPLAIN {name}:")
        for line in text.splitlines():
            print("    " + line)
    return {"plans": out, "launches": {"exchange_rank": 0,
                                       "ordered_fold": 0}}


class _MLP:
    """The 2-layer MLP of 21(d) (width 64, float32), its weights from
    ``default_rng(seed)``; ``module(device)`` builds the torch module."""

    def __init__(self, d_in: int = 4, width: int = 64, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.w0 = (rng.normal(size=(width, d_in)) / 2).astype(np.float32)
        self.b0 = rng.normal(size=width).astype(np.float32)
        self.w1 = (rng.normal(size=(1, width)) / 8).astype(np.float32)
        self.b1 = rng.normal(size=1).astype(np.float32)

    def module(self, torch):
        class Mlp(torch.nn.Module):
            def __init__(s):
                super().__init__()
                s.l0 = torch.nn.Linear(self.w0.shape[1], self.w0.shape[0])
                s.l1 = torch.nn.Linear(self.w0.shape[0], 1)

            def forward(s, x):
                return s.l1(torch.relu(s.l0(x)))[:, 0]

        m = Mlp()
        m.load_state_dict({k: torch.from_numpy(v) for k, v in (
            ("l0.weight", self.w0), ("l0.bias", self.b0),
            ("l1.weight", self.w1), ("l1.bias", self.b1))})
        return m


def _ml_job(torch, device, feats, keys, ts, mlp, batch=1 << 16):
    """ML_PREDICT(TorchModel) -> TUMBLE(1 s) SUM(y) GROUP BY k, the model
    and the job on ``device``."""
    from flink_tpu_torch.connectors.sources import CollectionSource
    from flink_tpu_torch.core.records import RecordBatch
    from flink_tpu_torch.ml import TorchModel
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy

    env, tenv = _tenv(device, **{"execution.micro-batch.size": batch})
    batches = [RecordBatch.from_pydict(
        {"k": keys[i:i + batch], "ts": ts[i:i + batch],
         "x": feats[i:i + batch]}, timestamps=ts[i:i + batch])
        for i in range(0, len(keys), batch)]
    tenv.create_temporary_view(
        "feats", env.from_source(
            CollectionSource(batches),
            WatermarkStrategy.for_bounded_out_of_orderness(0)),
        columns=["k", "ts", "x"], time_field="ts")
    tenv.create_temporary_model(
        "mlp", TorchModel(mlp.module(torch), ["x"], ["y"], device=device))
    tenv.execute_sql("CREATE VIEW scored AS SELECT k, ts, y FROM "
                     "ML_PREDICT(TABLE feats, MODEL mlp, DESCRIPTOR(x))")
    reset_counts()
    t0 = time.perf_counter()
    out = tenv.execute_sql(
        "SELECT k, window_end, SUM(y) AS s FROM TABLE(TUMBLE(TABLE scored, "
        "DESCRIPTOR(ts), INTERVAL '1' SECOND)) GROUP BY k, window_start, "
        "window_end").to_batch()
    _sync(torch, device)
    return out, time.perf_counter() - t0, read_counts()


def ml_predict_card(torch, device: str = "cuda", records: int = 1_000_000
                    ) -> dict:
    """21(d) ML_PREDICT: the MLP as a TorchModel on the card feeding a
    tumbling SUM over ``records``; its predictions held to the same module
    on the CPU (rtol 1e-5, atol 1e-5: float32 matmuls that associate
    differently), the job's window sums to the CPU job's (rtol 1e-4, atol
    1e-3: ~1,000 such predictions a window)."""
    from flink_tpu_torch.ml import TorchModel

    rng = np.random.default_rng(31)
    feats = rng.normal(size=(records, 4)).astype(np.float32)
    keys = rng.integers(0, 100, records).astype(np.int64)
    ts = (np.arange(records, dtype=np.int64) * 1000) // RATE
    mlp = _MLP()
    card = TorchModel(mlp.module(torch), ["x"], ["y"], device=device)
    host = TorchModel(mlp.module(torch), ["x"], ["y"], device="cpu")
    pc, ph = card.predict({"x": feats})["y"], host.predict({"x": feats})["y"]
    err = np.abs(pc.astype(np.float64) - ph)
    fails = []
    if (err > 1e-5 + 1e-5 * np.abs(ph)).any():
        fails.append(f"predictions off the CPU module by {err.max()}")
    card_ms = cuda_ms(lambda: card.predict({"x": feats[:1 << 16]}), 20) \
        if device == "cuda" else None
    out, dt, counts = _ml_job(torch, device, feats, keys, ts, mlp)
    ref, _, _ = _ml_job(torch, "cpu", feats, keys, ts, mlp)
    if not (np.array_equal(out["k"], ref["k"])
            and np.array_equal(out["window_end"], ref["window_end"])):
        fails.append("the job's windows differ from the CPU job's")
    s_err = np.abs(np.asarray(out["s"], np.float64) - np.asarray(ref["s"]))
    if (s_err > 1e-3 + 1e-4 * np.abs(np.asarray(ref["s"]))).any():
        fails.append(f"window sums off the CPU job's by {s_err.max()}")
    if device == "cuda" and counts["ordered_fold"] <= 0:
        fails.append("the tumbling SUM did not launch the ordered fold")
    _gate("phase 21(d) ML_PREDICT", fails)
    row = {"records": records, "seconds": dt, "events_per_s": records / dt,
           "windows": len(out), "max_abs_err_prediction": float(err.max()),
           "max_abs_err_window_sum": float(s_err.max()),
           "predict_64k_rows_ms": card_ms, "launches": counts}
    print(f"phase 21(d) ML_PREDICT: TorchModel MLP (2 x 64, float32) on the "
          f"card -> TUMBLE SUM over {records:,} records in {dt:.3f} s = "
          f"{records / dt:,.0f} events/s; predictions within "
          f"{row['max_abs_err_prediction']:.3g} of the CPU module, "
          f"{len(out)} window sums within {row['max_abs_err_window_sum']:.3g}"
          f" of the CPU job; one 65,536-row predict {card_ms} ms; launches "
          f"{counts}")
    return row


def host_heap_revenue(torch, records: int = 2_000_000) -> dict:
    """21(d) state.backend: Q5-revenue at P=1 (bench.py's slot layout)
    with the state on the CPU (host-heap) while execution.device is the
    card, against the same job with the state on the card: rows equal in
    order, bit for bit."""
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.nexmark import BidSource
    from flink_tpu_torch.benchmarks.q5_profile import P1_SETTINGS
    from flink_tpu_torch.connectors.sinks import CollectSink

    runs = {}
    for backend in ("tpu-slot-table", "host-heap"):
        env = StreamExecutionEnvironment(Configuration({
            "execution.micro-batch.size": 1 << 20,
            "execution.device": "cuda", **P1_SETTINGS,
            "state.window-layout": "slots", "state.backend": backend}))
        sink = CollectSink()
        build_revenue(env, BidSource(
            total_records=records, num_auctions=AUCTIONS,
            events_per_second_of_eventtime=RATE)).sink_to(sink)
        reset_counts()
        t0 = time.perf_counter()
        env.execute()
        torch.cuda.synchronize()
        runs[backend] = (sink, time.perf_counter() - t0, read_counts())
    card, host = runs["tpu-slot-table"], runs["host-heap"]
    _batches_equal("21(d) host-heap vs card", [host[0].result()],
                   [card[0].result()])
    rows = len(card[0].result())
    if card[2]["ordered_fold"] <= 0:
        raise AssertionError("21(d): the card run did not launch the fold")
    row = {"records": records, "rows": rows, "card_s": card[1],
           "host_heap_s": host[1], "launches": card[2],
           "host_heap_launches": host[2]}
    print(f"phase 21(d) state.backend: Q5-revenue P=1 over {records:,} bids "
          f"with host-heap state ({host[1]:.2f} s, launches {host[2]}) == "
          f"the card's state ({card[1]:.2f} s) bit for bit, {rows:,} rows")
    return row


def savepoint_reader(torch, path: str) -> dict:
    """21(d) State Processor API: ``SavepointReader`` reads 19(c)'s stop
    savepoint (Q5 at P=8); the keyed table's rows and count sums equal
    those of the live state: a P=8 window operator on the card restored
    from the savepoint and snapshotted back from its planes."""
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.nexmark import BidSource, build_q5
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.runtime.operators import OperatorContext
    from flink_tpu_torch.state_processor import SavepointReader

    reader = SavepointReader.load(path)
    uids = [u for u in reader.operators() if reader.has_keyed_state(u)]
    if len(uids) != 1:
        raise AssertionError(f"21(d): keyed operators {uids}")
    table = reader.read_keyed_state(uids[0])
    env = StreamExecutionEnvironment(Configuration({
        "parallelism.default": 8, "execution.device": "cuda"}))
    build_q5(env, BidSource(total_records=10, num_auctions=AUCTIONS),
             size_ms=SIZE, slide_ms=SLIDE,
             device_top_k=TOP_K).sink_to(CollectSink())
    graph = env.get_stream_graph()
    node = [t for t in graph.nodes if graph.stable_id(t) == uids[0]][0]
    op = node.operator_factory()
    op.open(OperatorContext(parallelism=8, device="cuda"))
    op.restore_state(reader.read_state(uids[0]))
    live = op.snapshot_state()
    from flink_tpu_torch.state_processor import _find_table

    live_table = _find_table(live)
    got = {"rows": len(table), "count_sum": int(np.asarray(
        table["leaf_0"], np.int64).sum()), "key_groups": int(len(np.unique(
            np.asarray(table["key_group"]))))}
    want = {"rows": len(live_table["key_id"]),
            "count_sum": int(np.asarray(live_table["leaf_0"],
                                        np.int64).sum()),
            "key_groups": int(len(np.unique(np.asarray(
                live_table["key_group"]))))}
    if got != want or got["rows"] == 0:
        raise AssertionError(f"21(d) SavepointReader {got} vs live {want}")
    print(f"phase 21(d) State Processor API: SavepointReader read 19(c)'s "
          f"savepoint (operator {uids[0]}): {got['rows']:,} keyed rows, "
          f"count sum {got['count_sum']:,} over {got['key_groups']} key "
          f"groups == the state restored on the card")
    return {**got, "operator": uids[0],
            "launches": {"exchange_rank": 0, "ordered_fold": 0}}


def v2_keyed_card(torch, device: str = "cuda", records: int = 1_000_000,
                  keys: int = 10_000) -> dict:
    """21(d) DataStream V2: a keyed process function counting per key in a
    DeviceValueState (on the operator's device), emitting at an end timer;
    card == CPU row for row and == np.bincount."""
    from flink_tpu_torch import Configuration
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.connectors.sources import DataGenSource
    from flink_tpu_torch.core.records import KEY_ID_FIELD, RecordBatch
    from flink_tpu_torch.datastream.v2 import (
        ExecutionEnvironment,
        OneInputStreamProcessFunction,
    )
    from flink_tpu_torch.state.async_state import DeviceValueStateDescriptor

    desc = DeviceValueStateDescriptor("n", np.int64, 0)

    class Count(OneInputStreamProcessFunction):
        def process_batch(self, batch, out, ctx):
            kid = np.asarray(batch[KEY_ID_FIELD])
            uniq, occ = np.unique(kid, return_counts=True)
            st = ctx.state(desc)
            st.put(uniq, np.asarray(st.get(uniq)) + occ)
            ctx.timer_service().register_event_time_timers(
                uniq, np.full(len(uniq), 1 << 50))

        def on_timer(self, key_ids, timestamps, out, ctx):
            out.collect(RecordBatch({KEY_ID_FIELD: key_ids,
                                     "count": ctx.state(desc).get(key_ids)}))

    res = {}
    for dev in (device, "cpu"):
        env = ExecutionEnvironment.get_instance(Configuration({
            "execution.device": dev, "execution.micro-batch.size": 1 << 16}))
        sink = CollectSink()
        env.from_source(DataGenSource(
            total_records=records, num_keys=keys,
            events_per_second_of_eventtime=RATE)).key_by("key").process(
                Count()).to_sink(sink)
        t0 = time.perf_counter()
        env.execute("v2-count")
        _sync(torch, dev)
        res[dev] = (sink.result(), time.perf_counter() - t0)
    _batches_equal("21(d) V2 card vs CPU", [res[device][0]], [res["cpu"][0]])
    out = res[device][0]
    src = DataGenSource(total_records=records, num_keys=keys,
                        events_per_second_of_eventtime=RATE)
    src.open()
    want = np.zeros(keys, np.int64)
    while (b := src.poll_batch(1 << 20)) is not None:
        want += np.bincount(b["key"], minlength=keys)
    got = np.zeros(keys, np.int64)
    got[np.asarray(out[KEY_ID_FIELD])] = np.asarray(out["count"])
    if not np.array_equal(got, want):
        raise AssertionError("21(d) V2: counts differ from np.bincount")
    dt = res[device][1]
    print(f"phase 21(d) DataStream V2: keyed process with a DeviceValueState"
          f" over {records:,} records, {keys:,} keys on the card in "
          f"{dt:.3f} s = {records / dt:,.0f} events/s; card == CPU row for "
          f"row == np.bincount")
    return {"records": records, "keys": keys, "seconds": dt,
            "events_per_s": records / dt,
            "launches": {"exchange_rank": 0, "ordered_fold": 0}}


def phase_slice21(torch, device: str = "cuda", savepoint: str = None,
                  small: bool = False) -> dict:
    """Phase 21: OVER on both engines and through SQL, the lookup join into
    a filesystem table exactly once at P=8, EXPLAIN, and 11d on the card
    (ML_PREDICT, host-heap, SavepointReader over 19(c)'s savepoint,
    DataStream V2). ``device="cpu", small=True`` rehearses it at a cut size
    without a card (the card-vs-CPU checks then compare the CPU with
    itself; host-heap and the savepoint reader need the card)."""
    if device == "cuda":
        from flink_tpu_torch.stateplane import cuda_build

        cuda_build.build_all()
    cut = ({"over": {"timed": 4, "host_timed_at_50k": 1,
                     "key_counts": (100, 2_000)},
            "sql": {"events": 300_000}, "lookup": {"bids": 400_000,
                                                   "batch": 1 << 14},
            "ml": {"records": 100_000}, "v2": {"records": 100_000}}
           if small else {"over": {"timed": 10},
                          **{k: {} for k in ("sql", "ml", "v2")},
                          # cut from 2M when phase 24 came (the script's
                          # time): 15 batches, the failure past 9
                          "lookup": {"bids": 1_000_000, "batch": 1 << 16}})
    t0 = time.perf_counter()
    parts = {}
    times = {}

    def part(name, fn, *a, **k):
        t = time.perf_counter()
        parts[name] = fn(*a, **k)
        times[name] = time.perf_counter() - t

    part("over_bench", lambda: {"rows": over_bench(torch, device,
                                                   **cut["over"]),
                                "launches": {"exchange_rank": 0,
                                             "ordered_fold": 0}})
    part("over_sql", row4_over_sql, torch, device, **cut["sql"])
    part("lookup_fs", lookup_fs_exactly_once, torch, device,
         **cut["lookup"])
    part("explain", explain_plans, torch, device)
    part("ml_predict", ml_predict_card, torch, device, **cut["ml"])
    if device == "cuda":
        part("host_heap", host_heap_revenue, torch)
        if savepoint is not None:
            part("savepoint_reader", savepoint_reader, torch, savepoint)
    part("v2", v2_keyed_card, torch, device, **cut["v2"])
    launches = {k: sum(p["launches"][k] for p in parts.values())
                for k in ("exchange_rank", "ordered_fold")}
    print(f"phase 21: {time.perf_counter() - t0:.1f} s (parts "
          f"{ {k: round(v, 1) for k, v in times.items()} }); launches "
          f"{launches}")
    print("slice21 " + json.dumps({k: v for k, v in parts.items()
                                   if k != "explain"}, default=str))
    return {**parts, "launches": launches, "part_seconds": times,
            "seconds": time.perf_counter() - t0}


# ------------------------------------------------------------- phase 22


class _FailAfter:
    """A stateless map that raises once ``n`` records went through it and
    ``root`` holds checkpoint 2 (22(c)'s crash, after checkpoint 2 however
    the checkpoints' trigger falls); past ``n`` records it holds each
    batch 0.5 s until then, so that the coordinator's barriers overtake
    the source. ``seen`` counts the records."""

    def __init__(self, n: int, root: str = None):
        self.n, self.root, self.seen = n, root, 0

    def __call__(self, batch):
        if self.seen > self.n:
            if self.root is None or self._checkpoints() >= 2:
                raise RuntimeError("injected failure (22c)")
            time.sleep(0.5)
        self.seen += len(batch)
        return batch

    def _checkpoints(self) -> int:
        """The newest complete checkpoint's id (retention prunes the
        older ones)."""
        from flink_tpu_torch.checkpoint.storage import CheckpointStorage

        return CheckpointStorage(self.root).latest_checkpoint_id() or 0


def _stage_run(torch, build, device, conf, records, executor=None,
               sink=None, restore_from=None):
    """One job through the public API (or ``executor(config)``'s ``run``)
    with the launch counts set to 0 just before it; returns (sink,
    result, elapsed s, launches). A caller that expects the job to fail
    passes its own ``sink``."""
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.connectors.sinks import CollectSink

    env = StreamExecutionEnvironment(Configuration({
        "execution.micro-batch.size": 1 << 20, "execution.device": device,
        **conf}))
    sink = sink if sink is not None else CollectSink()
    build(env, records).sink_to(sink)
    reset_counts()
    t0 = time.perf_counter()
    result = (executor(env.config).run(env.get_stream_graph())
              if executor is not None
              else env.execute(restore_from=restore_from))
    if device == "cuda":
        torch.cuda.synchronize()
    return sink, result, time.perf_counter() - t0, read_counts()


def _revenue_job(fail_after=None):
    """Q5-revenue (phase 6's job), with 22(c)'s map after the source (the
    same name in the crashed and the resumed graph)."""
    from flink_tpu_torch.benchmarks.nexmark import BidSource
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
    from flink_tpu_torch.windowing.assigners import SlidingEventTimeWindows

    def build(env, records):
        ds = env.from_source(
            BidSource(total_records=records, num_auctions=AUCTIONS,
                      events_per_second_of_eventtime=RATE),
            WatermarkStrategy.for_bounded_out_of_orderness(0))
        if fail_after is not None:
            ds = ds.map(fail_after, name="maybe_fail")
        return (ds.key_by("auction")
                .window(SlidingEventTimeWindows.of(SIZE, SLIDE))
                .sum("price"))

    return build


def _q5_job(env, records):
    from flink_tpu_torch.benchmarks.nexmark import BidSource, build_q5

    return build_q5(env, BidSource(total_records=records,
                                   num_auctions=AUCTIONS,
                                   events_per_second_of_eventtime=RATE),
                    size_ms=SIZE, slide_ms=SLIDE, device_top_k=TOP_K)


def _stage_check_q5(sink, records, label):
    """The largest count of every window across the subtasks' arg-max
    rows, and the auctions with it, against phase 5's oracle."""
    from flink_tpu_torch.benchmarks.nexmark import BidSource

    best = {}
    for r in sink.rows():
        c = int(r["count"])
        b, ws = best.get(r["window_end"], (-1, set()))
        if c > b:
            best[r["window_end"]] = (c, {int(r["auction"])})
        elif c == b:
            ws.add(int(r["auction"]))
    want = q5_oracle_cached(records)
    if set(best) != set(want):
        raise AssertionError(f"{label}: {len(best)} windows, oracle "
                             f"{len(want)}")
    for w, (b, winners) in want.items():
        g_b, g_w = best[w]
        if g_b != b or not g_w <= winners:
            raise AssertionError(f"{label} window {w}: got ({g_b}, "
                                 f"{sorted(g_w)[:5]}), oracle ({b}, "
                                 f"{sorted(winners)[:5]})")
    return len(best)


def phase_stage(torch, device: str = "cuda", small: bool = False,
                records: int = 10_000_000, batch_records: int = 2_000_000
                ) -> dict:
    """Phase 22: the stage executor (22a-22d) and the flight recorder
    (22e). ``device="cpu", small=True`` rehearses it at a cut size without
    a card."""
    from flink_tpu_torch.checkpoint.storage import CheckpointStorage
    from flink_tpu_torch.cluster.stage_executor import StageParallelExecutor
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.runtime.sort_merge_shuffle import (
        SortMergeShuffleService,
    )

    if device == "cuda":
        from flink_tpu_torch.stateplane import cuda_build

        cuda_build.build_all()
    if small:
        records, batch_records = 1_500_000, 200_000
    batch = (1 << 20) if not small else (1 << 14)
    base = {"execution.micro-batch.size": batch,
            "execution.local-agg": False,
            "state.slot-table.capacity": 1 << 20 if not small else 1 << 16}
    t_phase = time.perf_counter()
    launches = {"exchange_rank": 0, "ordered_fold": 0}
    out = {}

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    # (22a) Q5-revenue at 4 subtasks
    want, cnt = revenue_oracle_cached(records)
    sink, res, dt, counts = _stage_run(
        torch, _revenue_job(), device,
        {**base, "execution.stage-parallelism": 4}, records)
    add(counts)
    if device == "cuda" and counts["ordered_fold"] <= 0:
        raise AssertionError("22(a) ran without launching the ordered fold")
    rows, windows = check_revenue_rows(sink.result(), want, cnt, "22(a)")
    out["a"] = {"records": records, "elapsed_s": dt,
                "events_per_s": records / dt, "rows": rows,
                "windows": windows, "launches": counts,
                "subtask_records_in": res.metrics["subtask_records_in"]}
    print(f"phase 22(a): Q5-revenue at 4 subtasks, {records} bids in "
          f"{dt:.3f} s = {records / dt:.0f} events/s; all {rows} sums over "
          f"{windows} windows equal phase 6's oracle bit for bit; "
          f"launches {counts}")

    # (22b) Q5 at 2 subtasks x 4 shards
    sink, res, dt, counts = _stage_run(
        torch, _q5_job, device,
        {"execution.micro-batch.size": batch,
         "execution.stage-parallelism": 2,
         "execution.stage-mesh-devices": 4}, records)
    add(counts)
    if device == "cuda" and counts["exchange_rank"] <= 0:
        raise AssertionError("22(b) ran without launching the rank kernel")
    n_windows = _stage_check_q5(sink, records, "22(b)")
    out["b"] = {"records": records, "elapsed_s": dt,
                "events_per_s": records / dt, "windows": n_windows,
                "launches": counts}
    print(f"phase 22(b): Q5 at 2 subtasks x 4 shards, {records} bids in "
          f"{dt:.3f} s = {records / dt:.0f} events/s; {n_windows} windows' "
          f"winners equal phase 5's oracle; launches {counts}")

    # (22c) crash at 4 subtasks, resume at 2 and single-slot; unaligned
    out["c"] = []
    for unaligned, resumes in ((False, (2, 0)), (True, (4,))):
        with tempfile.TemporaryDirectory(dir=".") as ckpt:
            every = {"state.checkpoints.dir": ckpt,
                     "execution.checkpointing.every-n-source-batches": 2,
                     "execution.checkpointing.unaligned": unaligned}
            crash = _FailAfter(records * 2 // 5, ckpt)
            c_sink = CollectSink()
            t0 = time.perf_counter()
            try:
                _stage_run(torch, _revenue_job(crash), device,
                           {**base, **every,
                            "execution.micro-batch.size": batch // 2,
                            "execution.stage-parallelism": 4},
                           records, sink=c_sink)
            except RuntimeError as e:
                if "injected failure" not in str(e):
                    raise
            else:
                raise AssertionError("22(c): the job did not crash")
            crashed_s = time.perf_counter() - t0
            storage = CheckpointStorage(ckpt)
            newest = storage.latest_checkpoint_id()
            if newest is None or newest < 2:
                raise AssertionError(f"22(c): crashed after checkpoint "
                                     f"{newest}, not after 2")
            ck_bytes = sum(
                e.stat().st_size for e in os.scandir(
                    os.path.join(ckpt, f"chk-{newest}")) if e.is_file())
            for par in resumes:
                conf = {**base, "execution.stage-parallelism": par,
                        "execution.checkpointing.unaligned": unaligned}
                r_sink, r_res, dt, counts = _stage_run(
                    torch, _revenue_job(_FailAfter(1 << 62)), device, conf,
                    records, restore_from=ckpt)
                add(counts)
                if device == "cuda" and counts["ordered_fold"] <= 0:
                    raise AssertionError("22(c) resumed without the "
                                         "ordered fold")
                crashed_rows = c_sink.result()
                rows_r, _ = check_revenue_rows(r_sink.result(), want, cnt,
                                               "22(c) resumed", full=False)
                rows_c, _ = check_revenue_rows(crashed_rows, want, cnt,
                                               "22(c) crashed", full=False)
                covered = _pairs(crashed_rows) | _pairs(r_sink.result())
                if len(covered) != int((cnt > 0).sum()):
                    raise AssertionError("22(c): the two runs miss "
                                         f"{int((cnt > 0).sum()) - len(covered)}"
                                         " (auction, window) rows")
                read = r_res.metrics.get(
                    "records", r_res.metrics.get("records_emitted_by_sources"))
                replayed = crash.seen - (records - read)
                item = {"unaligned": unaligned, "crashed_at": crash.seen,
                        "checkpoint": newest, "checkpoint_bytes": ck_bytes,
                        "resumed_at": par or "single-slot",
                        "restore_ms": r_res.metrics["restore_ms"],
                        "records_replayed": replayed,
                        "resumed_records": read,
                        "resumed_s": dt, "crashed_run_s": crashed_s,
                        "launches": counts}
                out["c"].append(item)
                print(f"phase 22(c): {'unaligned' if unaligned else 'aligned'}"
                      f" crash after {crash.seen} records at 4 subtasks "
                      f"(checkpoint {newest}, {ck_bytes} bytes), resumed at "
                      f"{par or 'single-slot'}: restore "
                      f"{r_res.metrics['restore_ms']:.2f} ms, {replayed} "
                      f"records replayed; {rows_c} + {rows_r} rows equal the "
                      f"oracle and cover it; launches {counts}")

    # (22d) batch mode over the sort-merge shuffle, managed memory; its
    # runs go through the native codec, which falls back to pickle
    # silently where it did not build
    from flink_tpu_torch.native.codec import codec_available

    if not codec_available():
        raise AssertionError("22(d): the native codec did not build")
    want_b, cnt_b = revenue_oracle_cached(batch_records)
    svc = SortMergeShuffleService()
    spilled = {}

    def with_service(cfg):
        ex = StageParallelExecutor(cfg, shuffle_service=svc)
        spilled["ex"] = ex
        return ex

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    try:
        sink, res, dt, counts = _stage_run(
            torch, _revenue_job(), device,
            {**base, "execution.stage-parallelism": 4,
             "execution.runtime-mode": "batch",
             "memory.device.size": 8 << 30}, batch_records,
            executor=with_service)
        spill_bytes = sum(
            os.path.getsize(os.path.join(d, f))
            for d, _, fs in os.walk(svc.directory) for f in fs)
    finally:
        svc.close()
    add(counts)
    if device == "cuda" and counts["ordered_fold"] <= 0:
        raise AssertionError("22(d) ran without the ordered fold")
    rows, windows = check_revenue_rows(sink.result(), want_b, cnt_b, "22(d)")
    mm = spilled["ex"].memory_manager
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    out["d"] = {"records": batch_records, "elapsed_s": dt,
                "events_per_s": batch_records / dt, "rows": rows,
                "spilled_bytes": spill_bytes,
                "reserved_bytes": mm.reserved_bytes,
                "reservations": len(mm.usage()),
                "max_memory_allocated": peak, "launches": counts}
    print(f"phase 22(d): batch mode over sort-merge (native codec), "
          f"{batch_records} bids in "
          f"{dt:.3f} s; {rows} rows equal the oracle; {spill_bytes} bytes "
          f"spilled; memory.device.size reservations {mm.reserved_bytes} "
          f"bytes over {len(mm.usage())} owners against "
          f"max_memory_allocated {peak}; launches {counts}")

    # (22e) the flight recorder on and off
    out["e"] = _flight_on_off(torch, device, records, batch)
    add(out["e"]["launches"])
    seconds = time.perf_counter() - t_phase
    print(f"phase 22: {seconds:.1f} s; launches {launches}")
    print("stage " + json.dumps(out, default=str))
    return {**out, "launches": launches, "seconds": seconds}


def _pairs(res):
    e = np.asarray(res["window_end"]) // SLIDE - 1
    a = np.asarray(res["auction"]).astype(np.int64)
    return set((e * AUCTIONS + a).tolist())


def q5_flight_rate(device: str, records: int, batch: int,
                   warmup: int = 0) -> dict:
    """Phase 5's job at P=8 once, with the recorder as this process has it
    (``FLINK_TPU_FLIGHT_RECORDER`` is read at import): events/s, the spans
    of the job by kind, and the registry's window gauges. ``warmup`` > 0
    runs the job over that many bids first, untimed (a fresh process's
    first job pays the allocator's and the kernels' first calls)."""
    import torch

    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.observe import flight_recorder as flight

    def job(n):
        env = StreamExecutionEnvironment(Configuration({
            "parallelism.default": 8, "execution.micro-batch.size": batch,
            "execution.device": device}))
        sink = CollectSink()
        _q5_job(env, n).sink_to(sink)
        return env, sink

    if warmup:
        env, _ = job(warmup)
        env.execute("q5-warmup")
    env, sink = job(records)
    flight.recorder().clear()
    reset_counts()
    t0 = time.perf_counter()
    result = env.execute("q5-flight")
    if device == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    kinds = {}
    for r in flight.recorder().snapshot():
        if r.job == "q5-flight":
            kinds[r.kind] = kinds.get(r.kind, 0) + 1
    snap = result.registry.snapshot()
    return {"enabled": flight.enabled(), "records": records,
            "elapsed_s": dt, "events_per_s": records / dt,
            "spans_by_kind": kinds, "launches": read_counts(),
            "window_gauges": {k.rsplit(".", 2)[-2] + "." + k.rsplit(".", 1)[-1]:
                              v for k, v in snap.items()
                              if ".window." in k},
            "late_dropped": [v for k, v in snap.items()
                             if k.endswith("numLateRecordsDropped")],
            "fired_rows": len(sink.rows())}


def _flight_on_off(torch, device, records, batch) -> dict:
    from flink_tpu_torch.observe import KNOWN_SPAN_KINDS
    from flink_tpu_torch.observe.export import (
        validate_trace_schema,
        write_chrome_trace,
    )

    on = q5_flight_rate(device, records, batch)
    if not on["enabled"] or not on["spans_by_kind"]:
        raise AssertionError("22(e): the recorder-on run recorded nothing")
    if device == "cuda" and on["launches"]["exchange_rank"] <= 0:
        raise AssertionError("22(e) ran without launching the rank kernel")
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out", "phase22e_trace.json")
    events = write_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] != "M"}
    problems = validate_trace_schema(trace, KNOWN_SPAN_KINDS)
    need = {"op.process", "op.watermark", "batch.ingest", "fire.dispatch"}
    if not need <= names or problems:
        raise AssertionError(f"22(e): the trace lacks {need - names} "
                             f"or fails its schema: {problems[:3]}")
    if len(on["late_dropped"]) != 1 or on["late_dropped"][0] != 0:
        raise AssertionError(f"22(e): numLateRecordsDropped "
                             f"{on['late_dropped']}, the job drops none")
    if not {"window.fireCount", "window.fireLatencyP99Ms"} <= set(
            on["window_gauges"]):
        raise AssertionError("22(e): the registry lacks the window gauges")
    # off: a fresh process with FLINK_TPU_FLIGHT_RECORDER=0 (read at
    # import), warmed first, records nothing and fires the same rows
    code = ("import json, chip_smoke; print('FLIGHT ' + json.dumps("
            f"chip_smoke.q5_flight_rate({device!r}, {records}, {batch}, "
            f"warmup={max(records // 5, 1)})))")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=900, env={**os.environ, "FLINK_TPU_FLIGHT_RECORDER": "0"})
    line = [x for x in proc.stdout.splitlines() if x.startswith("FLIGHT ")]
    if proc.returncode != 0 or not line:
        raise AssertionError(f"22(e) recorder-off process failed: "
                             f"{proc.stderr[-2000:]}")
    off_proc = json.loads(line[-1][len("FLIGHT "):])
    if off_proc["enabled"] or off_proc["spans_by_kind"] or \
            off_proc["fired_rows"] != on["fired_rows"]:
        raise AssertionError(f"22(e): the FLINK_TPU_FLIGHT_RECORDER=0 "
                             f"process recorded {off_proc['spans_by_kind']}"
                             f" or fired {off_proc['fired_rows']} rows")
    ratio = on["events_per_s"] / off_proc["events_per_s"]
    print(f"phase 22(e): Q5 P=8 {records} bids, recorder on "
          f"{on['events_per_s']:.0f} events/s (this process), off "
          f"{off_proc['events_per_s']:.0f} events/s "
          f"(FLINK_TPU_FLIGHT_RECORDER=0 in a fresh process, 0 spans); "
          f"on/off {ratio:.4f}; spans by kind {on['spans_by_kind']}; trace "
          f"{events} events in {path}; window gauges {on['window_gauges']};"
          f" numLateRecordsDropped 0; launches {on['launches']} (+ "
          f"{off_proc['launches']} in the fresh process)")
    launches = {k: on["launches"][k] + off_proc["launches"][k]
                for k in on["launches"]}
    return {"in_process": on, "off_process": off_proc,
            "on_over_off": ratio, "trace_events": events,
            "launches": launches}


# ---------------------------------------------------------------------------
# phase 23: the control plane (MiniCluster, failover, savepoints, HA, the
# standalone cluster, the RPC shuffle) and the Avro format
# ---------------------------------------------------------------------------

#: records -> phase 5's Q5 oracle ({window_end: (max, winners)})
_Q5_ORACLES = {}


def q5_oracle_cached(records: int):
    from flink_tpu_torch.benchmarks.nexmark import BidSource

    if records not in _Q5_ORACLES:
        _Q5_ORACLES[records] = q5_oracle(BidSource, records, AUCTIONS, RATE,
                                         SIZE, SLIDE)
    return _Q5_ORACLES[records]


class _Rows:
    """Rows read back from a JSON-lines file, as a sink's ``rows()``."""

    def __init__(self, path: str):
        from flink_tpu_torch.connectors.sinks import JsonLinesFileSink

        self._rows = JsonLinesFileSink.read_rows(path)

    def rows(self):
        return self._rows


def _progress_map(path: str, fail_after: int = 0, flag: str = ""):
    """A map for Q5's ``failmap`` slot: it appends a line per batch to
    ``path``; with ``fail_after`` it raises once, past that many batches,
    leaving ``flag`` (each deployment attempt unpickles its own copy, so
    the once-only flag lives in a file). A function of this script: the
    RPC serializer ships it by value."""

    def progress(batch):
        import os as _os

        with open(path, "a") as fh:
            fh.write(f"{len(batch)}\n")
        if fail_after:
            with open(path) as fh:
                seen = sum(1 for _ in fh)
            if seen > fail_after and not _os.path.exists(flag):
                with open(flag, "w") as fh:
                    fh.write("x")
                raise RuntimeError("injected UDF failure (23b)")
        return batch

    return progress


def _batches_seen(path: str) -> int:
    try:
        with open(path) as fh:
            return sum(1 for _ in fh)
    except FileNotFoundError:
        return 0


def _q5_env(device: str, batch: int, extra=None):
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment

    return StreamExecutionEnvironment(Configuration({
        "parallelism.default": 8, "execution.micro-batch.size": batch,
        "execution.device": device, **(extra or {})}))


def _until(pred, timeout: float, what: str, step: float = 0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(step)
    raise AssertionError(f"23: timed out after {timeout} s waiting for "
                         f"{what}")


def _mc_q5(torch, device, tmp, records, batch, cluster_conf, job_conf=None,
           fn=None, during=None, name="q5-mc", hold=None, started=None):
    """Q5 at P=8 through a MiniCluster into a JSON-lines file: (status,
    client, cluster-side master, rows view, s, launches, what ``during``
    returned). ``during(cluster, client, master)`` runs while the job
    runs; with ``hold`` the source holds its end of stream in that
    directory until released (``benchmarks/held.py``); ``started`` (a
    dict) gets the submit's time as ``"t0"``."""
    from flink_tpu_torch import Configuration
    from flink_tpu_torch.cluster.minicluster import MiniCluster
    from flink_tpu_torch.connectors.sinks import JsonLinesFileSink

    out = os.path.join(tmp, f"{name}.jsonl")
    env = _q5_env(device, batch, job_conf)
    if hold is not None:
        from flink_tpu_torch.benchmarks.held import HeldBidSource
        from flink_tpu_torch.benchmarks.nexmark import build_q5

        build_q5(env, HeldBidSource(hold, total_records=records,
                                    num_auctions=AUCTIONS,
                                    events_per_second_of_eventtime=RATE),
                 size_ms=SIZE, slide_ms=SLIDE, device_top_k=TOP_K
                 ).sink_to(JsonLinesFileSink(out))
    elif fn is None:
        _q5_job(env, records).sink_to(JsonLinesFileSink(out))
    else:
        _q5_with_map(env, records, fn).sink_to(JsonLinesFileSink(out))
    cluster = MiniCluster(Configuration(cluster_conf))
    try:
        reset_counts()
        t0 = time.perf_counter()
        if started is not None:
            started["t0"] = t0
        client = cluster.submit(env, name)
        master = cluster.dispatcher.master(client.job_id)
        seen = during(cluster, client, master) if during else None
        st = client.wait(timeout=600)
        _sync(torch, device)
        dt = time.perf_counter() - t0
        counts = read_counts()
    finally:
        cluster.shutdown()
    return st, client, master, _Rows(out), dt, counts, seen


def mc_rest_reads(cluster, client, master) -> dict:
    """23(a)'s reads while the job runs: the REST routes, the flamegraph
    and the dashboard."""
    import urllib.request

    _until(lambda: master.status == "RUNNING", 60, "the job to run")
    base = f"http://127.0.0.1:{cluster.rest_port}"

    def get(path, timeout=30):
        with urllib.request.urlopen(base + path, timeout=timeout) as r:
            return r.headers["Content-Type"], r.read()

    ov = json.loads(get("/overview")[1])
    jobs = json.loads(get("/jobs")[1])["jobs"]
    job = json.loads(get(f"/jobs/{client.job_id}")[1])
    fg = json.loads(get(f"/jobs/{client.job_id}/flamegraph?duration_ms=100"
                        )[1])
    ctype, html = get("/ui")
    if ov["taskexecutors"] != 2 or len(jobs) != 1 or \
            job["status"] not in ("RUNNING", "FINISHED") or \
            "root" not in fg or "text/html" not in ctype or \
            b"dashboard" not in html:
        raise AssertionError(f"23(a): REST reads {ov}, {jobs}, {job}")
    return {"overview": ov, "job_status_while_running": job["status"],
            "flamegraph_samples": fg["samples"], "ui_bytes": len(html)}


def mc_cli(rest_port: int, job_id: str) -> dict:
    """``cli list`` and ``cli info`` against the REST port, in process."""
    import contextlib
    import io

    from flink_tpu_torch.cli import main as cli_main

    outs = []
    for argv in (["list", "--rest", f"127.0.0.1:{rest_port}"],
                 ["info", job_id, "--rest", f"127.0.0.1:{rest_port}"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if cli_main(argv) != 0:
                raise AssertionError(f"23(a): cli {argv[0]} failed")
        outs.append(buf.getvalue())
    info = json.loads(outs[1])
    if job_id not in outs[0] or info["status"] != "FINISHED":
        raise AssertionError(f"23(a): cli printed {outs}")
    return {"list": outs[0].strip(), "info_status": info["status"]}


def mc_queries(cluster, client, hold: str, t0: float) -> dict:
    """24(c)'s reads at the held cut of a MiniCluster job: every auction
    through ``QueryableStateClient`` in 256-key batches, one key through
    the REST state route and ``cli query``; then the release. Returns the
    answers, the time to the cut and the client's numbers."""
    import contextlib
    import io
    import urllib.request

    from flink_tpu_torch.benchmarks.held import release, settle, wait_held
    from flink_tpu_torch.cli import main as cli_main
    from flink_tpu_torch.cluster.queryable_state import QueryableStateClient

    try:
        wait_held(hold, timeout_s=600)
        qs = QueryableStateClient(cluster)
        settle(lambda: qs.get_state_batch(client.job_id, Q5_OP,
                                          list(range(256))))
        to_cut = time.perf_counter() - t0
        t1 = time.perf_counter()
        ans = []
        for i in range(0, AUCTIONS, 256):
            ans.extend(qs.get_state_batch(
                client.job_id, Q5_OP,
                list(range(i, min(i + 256, AUCTIONS)))))
        dt = time.perf_counter() - t1
        stats = qs.stats()
        key = 7
        url = (f"http://127.0.0.1:{cluster.rest_port}/jobs/{client.job_id}"
               f"/state/{Q5_OP}?key={key}")
        with urllib.request.urlopen(url, timeout=30) as r:
            rest = json.loads(r.read())["state"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if cli_main(["query", client.job_id, Q5_OP, str(key), "--rest",
                         f"127.0.0.1:{cluster.rest_port}"]) != 0:
                raise AssertionError("24(c): cli query failed")
        cli = json.loads(buf.getvalue())["state"]
    finally:
        release(hold)
    as_json = {str(w): v for w, v in ans[key].items()}
    if rest != as_json or cli != as_json:
        raise AssertionError(f"24(c): key {key}: client {ans[key]}, REST "
                             f"{rest}, cli {cli}")
    return {"answers": ans, "to_cut_s": to_cut, "read_s": dt,
            "lookups_per_s": AUCTIONS / dt, "client_stats": stats,
            "key": key}


def minicluster_q5(torch, tmp: str, device: str = "cuda",
                   records: int = 10_000_000, batch: int = 1 << 20) -> dict:
    """23(a): phase 5's Q5 at P=8 through a MiniCluster of two in-process
    TaskExecutors, against the same job run directly. The cluster's
    source holds its end of stream: at the cut 24(c)'s reads run
    (``mc_queries``; phase 24 checks their answers), then it is released;
    events/s count to the cut, the reads excluded."""
    import urllib.request

    from flink_tpu_torch.cluster.history_server import HistoryServer

    archive = os.path.join(tmp, "history")
    direct_sink, direct_s, direct_counts, _ = _run_job(
        torch, lambda env: _q5_job(env, records), device)
    _stage_check_q5(direct_sink, records, "23(a) direct")

    reads = {}
    hold = os.path.join(tmp, "q5-mc-hold")
    started = {}

    def during_and_cli(cluster, client, master):
        reads.update(mc_rest_reads(cluster, client, master))
        reads["queries"] = mc_queries(cluster, client, hold, started["t0"])
        client.wait(timeout=600)
        reads["cli"] = mc_cli(cluster.rest_port, client.job_id)
        return reads

    st, client, master, rows, _, counts, _ = _mc_q5(
        torch, device, tmp, records, batch,
        {"rest.port": 0, "cluster.task-executors": 2,
         "heartbeat.interval-ms": 100, "jobmanager.archive.dir": archive},
        during=during_and_cli, hold=hold, started=started)
    dt = reads["queries"]["to_cut_s"]
    if st["status"] != "FINISHED" or st["attempt"] != 0:
        raise AssertionError(f"23(a): {st}")
    if device == "cuda" and counts["exchange_rank"] <= 0:
        raise AssertionError("23(a) ran without launching the rank kernel")
    windows = _stage_check_q5(rows, records, "23(a)")
    hs = HistoryServer(archive)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{hs.port}/jobs/{client.job_id}",
                timeout=30) as r:
            archived = json.loads(r.read())
    finally:
        hs.close()
    if archived["status"] != "FINISHED" or archived["metrics"][
            "records_emitted_by_sources"] != records:
        raise AssertionError(f"23(a): archive {archived.get('status')}")
    out = {"records": records, "elapsed_s": dt, "events_per_s": records / dt,
           "direct_events_per_s": records / direct_s, "windows": windows,
           "launches": {k: counts[k] + direct_counts[k] for k in counts},
           "mc_launches": counts, "direct_launches": direct_counts,
           "reads": {k: v for k, v in reads.items() if k != "queries"},
           "queries": reads["queries"], "archived_keys": sorted(archived)}
    print(f"phase 23(a): Q5 P=8 through a MiniCluster (2 TaskExecutors), "
          f"{records} bids to the held end of stream in {dt:.3f} s = "
          f"{records / dt:.0f} events/s (24(c)'s reads then ran at the "
          f"cut) "
          f"(direct {records / direct_s:.0f} events/s in the same call); "
          f"{windows} windows' winners equal phase 5's oracle; REST "
          f"/overview, /jobs, /jobs/<id> ({reads['job_status_while_running']}"
          f"), the flamegraph ({reads['flamegraph_samples']} samples) and "
          f"/ui read while it ran; the history server served its archive; "
          f"cli list / info read it; launches {counts} (direct "
          f"{direct_counts})")
    return out


def failover_q5(torch, tmp: str, device: str = "cuda",
                records: int = 10_000_000, batch: int = 1 << 20) -> dict:
    """23(b): the UDF crash after checkpoint 2, then the lost
    TaskExecutor."""
    from flink_tpu_torch.checkpoint.storage import CheckpointStorage

    out = {}
    # the UDF crash
    ck = os.path.join(tmp, "ck-udf")
    fn = _progress_map(os.path.join(tmp, "udf.progress"), fail_after=4,
                       flag=os.path.join(tmp, "udf.flag"))
    st, client, master, rows, dt, counts, _ = _mc_q5(
        torch, device, tmp, records, batch,
        {"rest.port": -1, "cluster.task-executors": 2,
         "heartbeat.interval-ms": 100},
        {"state.checkpoints.dir": ck,
         "execution.checkpointing.every-n-source-batches": 2,
         "restart-strategy.type": "fixed-delay",
         "restart-strategy.max-attempts": 3,
         "restart-strategy.delay-ms": 10}, fn=fn, name="q5-udf")
    if st["status"] != "FINISHED" or st["attempt"] != 1:
        raise AssertionError(f"23(b) UDF crash: {st}")
    windows = _stage_check_q5(rows, records, "23(b) UDF crash")
    restore_ms = client.result().metrics.get("restore_ms")
    if device == "cuda" and counts["exchange_rank"] <= 0:
        raise AssertionError("23(b) ran without launching the rank kernel")
    out["udf"] = {"attempt": st["attempt"], "restore_ms": restore_ms,
                  "elapsed_s": dt, "windows": windows, "launches": counts}
    print(f"phase 23(b): a UDF crash once after checkpoint 2 "
          f"(fixed-delay, 3 attempts, 10 ms): FINISHED at attempt "
          f"{st['attempt']} in {dt:.3f} s, restore {restore_ms} ms; "
          f"{windows} windows' winners (last row per window) equal the "
          f"oracle; launches {counts}")

    # the lost TaskExecutor
    ck = os.path.join(tmp, "ck-kill")
    timing = {}

    def kill(cluster, client, master):
        exec_id = f"{client.job_id}-0"
        victim = []

        def running():
            for te in cluster.executors:
                if te.task_status(exec_id)["status"] == "RUNNING":
                    victim[:] = [te.endpoint_id]
                    return True
            return False

        _until(running, 60, "attempt 0 to run")
        _until(lambda: (CheckpointStorage(ck).latest_checkpoint_id() or 0)
               >= 1, 60, "a checkpoint")
        t0 = time.perf_counter()
        cluster.kill_task_executor(victim[0])
        _until(lambda: master.status != "RUNNING" or master.attempt > 0,
               30, "the loss to be detected", step=0.001)
        timing["detection_ms"] = (time.perf_counter() - t0) * 1e3
        timing["victim"] = victim[0]
        timing["error"] = repr(master.error)
        return timing

    st, client, master, rows, dt, counts, _ = _mc_q5(
        torch, device, tmp, records, batch,
        {"rest.port": -1, "cluster.task-executors": 2,
         "heartbeat.interval-ms": 100},
        {"state.checkpoints.dir": ck,
         "execution.checkpointing.every-n-source-batches": 2,
         "heartbeat.timeout-ms": 1000,
         "restart-strategy.max-attempts": 3,
         "restart-strategy.delay-ms": 500}, during=kill, name="q5-kill")
    if st["status"] != "FINISHED" or st["attempt"] < 1:
        raise AssertionError(f"23(b) lost TaskExecutor: {st}")
    windows = _stage_check_q5(rows, records, "23(b) lost TaskExecutor")
    out["kill"] = {"attempt": st["attempt"], "elapsed_s": dt,
                   "detection_ms": timing["detection_ms"],
                   "error": timing["error"], "windows": windows,
                   "launches": counts}
    print(f"phase 23(b): {timing['victim']} killed while attempt 0 ran: "
          f"loss detected in {timing['detection_ms']:.1f} ms "
          f"({timing['error']}), FINISHED at attempt {st['attempt']} in "
          f"{dt:.3f} s; {windows} windows' winners equal the oracle; "
          f"launches {counts}")
    out["launches"] = {k: out["udf"]["launches"][k]
                       + out["kill"]["launches"][k] for k in counts}
    return out


def savepoints_q5(torch, tmp: str, device: str = "cuda",
                  records: int = 10_000_000, batch: int = 1 << 20) -> dict:
    """23(c): ``trigger_savepoint`` while the job runs, then
    ``stop_with_savepoint`` after about 5 batches, resumed through
    ``execute(restore_from=)``."""
    from flink_tpu_torch.checkpoint.savepoint import is_savepoint
    from flink_tpu_torch.connectors.sinks import CollectSink

    progress = os.path.join(tmp, "sp.progress")
    sp1, sp2 = os.path.join(tmp, "sp-live"), os.path.join(tmp, "sp-stop")
    got = {}

    def savepoints(cluster, client, master):
        _until(lambda: _batches_seen(progress) >= 2, 120, "two batches")
        t0 = time.perf_counter()
        got["live"] = client.trigger_savepoint(sp1)
        got["live_ms"] = (time.perf_counter() - t0) * 1e3
        _until(lambda: _batches_seen(progress) >= 5, 120, "five batches")
        t0 = time.perf_counter()
        got["stop"] = client.stop_with_savepoint(sp2)
        got["stop_ms"] = (time.perf_counter() - t0) * 1e3
        got["batches_at_stop"] = _batches_seen(progress)
        return got

    st, client, master, rows1, dt1, counts1, _ = _mc_q5(
        torch, device, tmp, records, batch,
        {"rest.port": -1, "cluster.task-executors": 1},
        fn=_progress_map(progress), during=savepoints, name="q5-sp")
    if st["status"] != "FINISHED" or got["live"] != sp1 or \
            got["stop"] != sp2 or not (is_savepoint(sp1)
                                       and is_savepoint(sp2)):
        raise AssertionError(f"23(c): {st}, {got}")
    env = _q5_env(device, batch)
    sink2 = CollectSink()
    _q5_with_map(env, records, _progress_map(
        os.path.join(tmp, "sp2.progress"))).sink_to(sink2)
    reset_counts()
    t0 = time.perf_counter()
    env.execute("q5-resume", restore_from=sp2)
    _sync(torch, device)
    dt2 = time.perf_counter() - t0
    counts2 = read_counts()
    part1 = {int(r["window_end"]) for r in rows1.rows()}
    part2 = {int(r["window_end"]) for r in sink2.rows()}
    if not part1 or not part2 or part1 & part2:
        raise AssertionError(f"23(c): parts of {len(part1)} and "
                             f"{len(part2)} windows, {len(part1 & part2)} "
                             "in both")

    class Both:
        def rows(self):
            return rows1.rows() + sink2.rows()

    windows = _stage_check_q5(Both(), records, "23(c)")
    if device == "cuda" and (counts1["exchange_rank"] <= 0
                             or counts2["exchange_rank"] <= 0):
        raise AssertionError("23(c) ran without launching the rank kernel")
    launches = {k: counts1[k] + counts2[k] for k in counts1}
    out = {"batches_at_stop": got["batches_at_stop"],
           "trigger_ms": got["live_ms"], "stop_ms": got["stop_ms"],
           "part1_windows": len(part1), "part2_windows": len(part2),
           "resume_s": dt2, "windows": windows, "launches": launches}
    print(f"phase 23(c): JobClient.trigger_savepoint while running "
          f"({got['live_ms']:.1f} ms), stop_with_savepoint after "
          f"{got['batches_at_stop']} batches ({got['stop_ms']:.1f} ms); "
          f"resumed on the card in {dt2:.3f} s; {len(part1)} + "
          f"{len(part2)} windows, disjoint, their union equals the oracle "
          f"({windows} windows); launches {launches}")
    return out


def ha_q5(torch, tmp: str, device: str = "cuda", records: int = 2_000_000,
          batch: int = 1 << 18) -> dict:
    """23(d): two MiniClusters over one HA storage dir; the leader is
    released while Q5 runs and the standby recovers and finishes it."""
    from flink_tpu_torch import Configuration
    from flink_tpu_torch.checkpoint.storage import CheckpointStorage
    from flink_tpu_torch.cluster.minicluster import MiniCluster
    from flink_tpu_torch.connectors.sinks import JsonLinesFileSink

    ha_dir, ck = os.path.join(tmp, "ha"), os.path.join(tmp, "ck-ha")
    out_path = os.path.join(tmp, "q5-ha.jsonl")
    conf = Configuration({
        "rest.port": -1, "high-availability.type": "filesystem",
        "high-availability.storageDir": ha_dir,
        "high-availability.lease-timeout-ms": 1000})
    leader = MiniCluster(conf)
    standby = None
    try:
        _until(lambda: leader._leader_election.is_leader, 30,
               "the first cluster to lead")
        standby = MiniCluster(conf)
        env = _q5_env(device, batch, {
            "state.checkpoints.dir": ck,
            "execution.checkpointing.every-n-source-batches": 2})
        _q5_job(env, records).sink_to(JsonLinesFileSink(out_path))
        reset_counts()
        t0 = time.perf_counter()
        job_id = leader.submit(env, "q5-ha").job_id
        master = leader.dispatcher.master(job_id)
        _until(lambda: master.status == "RUNNING", 60, "the job to run")
        _until(lambda: (CheckpointStorage(ck).latest_checkpoint_id() or 0)
               >= 1, 60, "a checkpoint")
        t_release = time.perf_counter()
        leader.shutdown()
        leader = None
        found = []
        _until(lambda: found.append(standby.dispatcher.master(job_id))
               or (found[-1] is not None and found[-1].status == "RUNNING"),
               60, "the standby to run the job", step=0.002)
        takeover_ms = (time.perf_counter() - t_release) * 1e3
        status = found[-1].wait(timeout=600)
        _sync(torch, device)
        dt = time.perf_counter() - t0
        counts = read_counts()
    finally:
        if leader is not None:
            leader.shutdown()
        if standby is not None:
            standby.shutdown()
    if status != "FINISHED":
        raise AssertionError(f"23(d): the standby's job is {status}")
    windows = _stage_check_q5(_Rows(out_path), records, "23(d)")
    if device == "cuda" and counts["exchange_rank"] <= 0:
        raise AssertionError("23(d) ran without launching the rank kernel")
    out = {"records": records, "takeover_ms": takeover_ms, "elapsed_s": dt,
           "windows": windows, "launches": counts}
    print(f"phase 23(d): HA, the leader released while Q5 ran ({records} "
          f"bids): the standby took over in {takeover_ms:.1f} ms, recovered "
          f"the job from the JobGraphStore and finished it on the card; "
          f"{windows} windows' winners equal the oracle; launches {counts}")
    return out


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def standalone_q5(torch, tmp: str, device: str = "cuda",
                  records: int = 2_000_000, batch: int = 1 << 18) -> dict:
    """23(e): this script hosts a standalone JobManager; a subprocess runs
    ``python3 -m flink_tpu_torch.cli taskexecutor`` on the card; Q5 runs
    there through ``remote_submit``. The subprocess's launches come back
    in the job's metric snapshot (``kernels.*``: its own counters, from
    0 at its start)."""
    import queue as _queue
    import threading

    from flink_tpu_torch import Configuration
    from flink_tpu_torch.cluster.minicluster import MiniCluster
    from flink_tpu_torch.cluster.standalone import remote_submit
    from flink_tpu_torch.connectors.sinks import JsonLinesFileSink

    port = _free_port()
    jm = MiniCluster(Configuration({
        "cluster.task-executors": 0, "rpc.port": port, "rest.port": -1,
        "heartbeat.interval-ms": 100}))
    proc = None
    lines: "_queue.Queue" = _queue.Queue()
    try:
        t_spawn = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "flink_tpu_torch.cli", "taskexecutor",
             "--jobmanager", jm.service.address,
             "-D", "heartbeat.interval-ms=100"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                         daemon=True).start()
        said, line = [], ""
        deadline = time.monotonic() + 120
        while not line.startswith("taskexecutor "):
            try:
                line = lines.get(timeout=max(deadline - time.monotonic(),
                                             0.01))
            except _queue.Empty:
                raise AssertionError(
                    f"23(e): the TaskExecutor process did not come up in "
                    f"120 s; it said {said[-5:]}") from None
            said.append(line)
        if device == "cuda" and "device cuda" not in line:
            raise AssertionError(f"23(e): the TaskExecutor process said "
                                 f"{line!r}")
        _until(lambda: len(jm.rm_gateway().executor_registry()) == 1, 60,
               "the TaskExecutor process to register")
        up_s = time.perf_counter() - t_spawn
        out_path = os.path.join(tmp, "q5-standalone.jsonl")
        env = _q5_env(device, batch)
        _q5_job(env, records).sink_to(JsonLinesFileSink(out_path))
        t0 = time.perf_counter()
        job_id, dispatcher = remote_submit(jm.service.address, env,
                                           "q5-standalone")
        _until(lambda: dispatcher.job_status(job_id)["status"] in
               ("FINISHED", "FAILED", "CANCELED"), 600, "the remote job",
               step=0.02)
        dt = time.perf_counter() - t0
        st = dispatcher.job_status(job_id)
        if st["status"] != "FINISHED":
            raise AssertionError(f"23(e): {st}")
        snap = jm.dispatcher.master(job_id).result.metric_snapshot
        counts = {"exchange_rank": int(snap["kernels.exchange_rank_launches"]),
                  "ordered_fold": int(snap["kernels.ordered_fold_launches"])}
    finally:
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        jm.shutdown()
    windows = _stage_check_q5(_Rows(out_path), records, "23(e)")
    if device == "cuda" and counts["exchange_rank"] <= 0:
        raise AssertionError("23(e) ran without launching the rank kernel")
    out = {"records": records, "process_up_s": up_s, "elapsed_s": dt,
           "events_per_s": records / dt, "device_line": line.strip(),
           "windows": windows, "launches": counts}
    print(f"phase 23(e): a standalone JobManager here and `python3 -m "
          f"flink_tpu_torch.cli taskexecutor` in a process of its own "
          f"(up and registered in {up_s:.1f} s; it said "
          f"{line.strip()!r}); Q5 P=8 over {records} bids through "
          f"remote_submit in {dt:.3f} s; {windows} windows' winners equal "
          f"the oracle; launches in that process {counts}; the process "
          f"stopped")
    return out


class _SplitGates:
    """The stage executor's shuffle service with keyed subtasks 2 and 3
    behind a second RPC service (their batches cross a socket)."""

    def __init__(self, svc_a, svc_b):
        self.a, self.b = svc_a, svc_b

    def create_partition(self, pid, n, credits=2):
        return self.a.create_partition(pid, n, credits)

    def create_gate(self, pids, sub):
        return (self.a if sub < 2 else self.b).create_gate(pids, sub)

    def close(self):
        pass


def grpc_shuffle_revenue(torch, device: str = "cuda",
                         records: int = 2_000_000,
                         batch: int = 1 << 19) -> dict:
    """23(f): 22(a)'s Q5-revenue at 4 subtasks over the RPC shuffle
    service (``shuffle.service: grpc``'s transport), subtasks 2-3 behind a
    second ``RpcService``."""
    from flink_tpu_torch.cluster.rpc import RpcService
    from flink_tpu_torch.cluster.rpc_shuffle import RpcShuffleService
    from flink_tpu_torch.cluster.stage_executor import StageParallelExecutor

    rpc_a, rpc_b = RpcService(), RpcService()
    try:
        svc_b = RpcShuffleService(rpc_b, route=lambda pid, sub: None)
        svc_a = RpcShuffleService(
            rpc_a, route=lambda pid, sub: None if sub < 2 else rpc_b.address)
        sink, res, dt, counts = _stage_run(
            torch, _revenue_job(), device,
            {"execution.micro-batch.size": batch,
             "execution.local-agg": False,
             "state.slot-table.capacity": 1 << 20,
             "execution.stage-parallelism": 4}, records,
            executor=lambda cfg: StageParallelExecutor(
                cfg, shuffle_service=_SplitGates(svc_a, svc_b)))
        sent = svc_a.bytes_sent
    finally:
        rpc_a.stop()
        rpc_b.stop()
    want, cnt = revenue_oracle_cached(records)
    rows, windows = check_revenue_rows(sink.result(), want, cnt, "23(f)")
    if device == "cuda" and counts["ordered_fold"] <= 0:
        raise AssertionError("23(f) ran without launching the ordered fold")
    if sent <= 0:
        raise AssertionError("23(f): no batch crossed the socket")
    out = {"records": records, "elapsed_s": dt, "events_per_s": records / dt,
           "rows": rows, "windows": windows, "bytes_over_socket": sent,
           "subtask_records_in": res.metrics["subtask_records_in"],
           "launches": counts}
    print(f"phase 23(f): Q5-revenue at 4 subtasks over the RPC shuffle "
          f"(subtasks 2-3 behind a second RpcService), {records} bids in "
          f"{dt:.3f} s = {records / dt:.0f} events/s; {sent} bytes crossed "
          f"the socket; all {rows} sums equal the {records}-bid oracle bit "
          f"for bit; launches {counts}")
    return out


#: 23(g)'s schemas: the writer's (v1) and an evolved reader's (v2: an
#: added field with a default)
ROW4_AVRO_V1 = {"type": "record", "name": "Bid", "fields": [
    {"name": "key", "type": "long"}, {"name": "value", "type": "double"},
    {"name": "ts", "type": "long"}]}
ROW4_AVRO_V2 = {"type": "record", "name": "Bid", "fields": [
    {"name": "key", "type": "long"}, {"name": "value", "type": "double"},
    {"name": "ts", "type": "long"},
    {"name": "region", "type": "string", "default": "emea"}]}


def row4_produce_avro(total: int, chunk: int = 1 << 18) -> float:
    """Row 4's events (``row4_produce``'s draws, partitions and order) as
    Avro records under ``ROW4_AVRO_V1`` on topic ``bench_avro``; returns
    the encode seconds."""
    from flink_tpu_torch.connectors.avro import encode_record, parse_schema
    from flink_tpu_torch.connectors.kafka import FakeBroker

    writer = parse_schema(json.dumps(ROW4_AVRO_V1))
    broker = FakeBroker.get("bench")
    broker.create_topic("bench_avro", ROW4_PARTS)
    rng = np.random.default_rng(1)
    produced, enc_s = 0, 0.0
    while produced < total:
        n = min(chunk, total - produced)
        ks = rng.integers(0, ROW4_KEYS, n).astype(np.int64)
        vs = rng.random(n)
        ts = (np.arange(produced, produced + n, dtype=np.int64)
              * 1000) // RATE
        for p in range(ROW4_PARTS):
            m = ks % ROW4_PARTS == p
            t0 = time.perf_counter()
            recs = [encode_record(writer, {"key": k, "value": v, "ts": t})
                    for k, v, t in zip(ks[m].tolist(), vs[m].tolist(),
                                       ts[m].tolist())]
            enc_s += time.perf_counter() - t0
            broker.append_raw("bench_avro", p, recs, timestamps=ts[m])
        produced += n
    return enc_s


def _row4_avro_job(torch, device: str, fmt: str):
    env, tenv = _tenv(device, **{"execution.micro-batch.size": 1 << 16})
    if fmt == "avro":
        tenv.execute_sql(
            "CREATE TABLE bench_avro (key BIGINT, value DOUBLE, ts BIGINT, "
            "WATERMARK FOR ts AS ts) WITH ('connector'='kafka', "
            "'topic'='bench_avro', 'broker'='bench', 'format'='avro', "
            f"'avro.schema'='{json.dumps(ROW4_AVRO_V2)}', "
            f"'avro.writer-schema'='{json.dumps(ROW4_AVRO_V1)}')")
        sql = ROW4_SQL.replace("bench_bids", "bench_avro")
    else:
        tenv.execute_sql(ROW4_DDL)
        sql = ROW4_SQL
    reset_counts()
    t0 = time.perf_counter()
    batch = tenv.execute_sql(sql).to_batch()
    _sync(torch, device)
    return batch, time.perf_counter() - t0, read_counts()


def avro_row4(torch, device: str = "cuda", events: int = 1_000_000) -> dict:
    """23(g): BASELINE row 4's topic as Avro (v1 writer) read under an
    evolved v2 reader through ``'format'='avro'`` into HOP(2 s, 10 s)
    ``SUM(value)``: every sum equal to the same events through the raw
    format bit for bit."""
    row4_produce(events)
    enc_s = row4_produce_avro(events)
    raw, raw_s, raw_counts = _row4_avro_job(torch, device, "raw")
    avro, avro_s, avro_counts = _row4_avro_job(torch, device, "avro")
    _batches_equal("23(g) avro vs raw", [avro], [raw])
    checked = row4_check(avro, events)
    if device == "cuda" and avro_counts["ordered_fold"] <= 0:
        raise AssertionError("23(g) ran without launching the ordered fold")
    launches = {k: raw_counts[k] + avro_counts[k] for k in raw_counts}
    out = {"events": events, "encode_s": enc_s,
           "raw_events_per_s": events / raw_s,
           "avro_events_per_s": events / avro_s, "rows": checked,
           "launches": launches, "avro_launches": avro_counts}
    print(f"phase 23(g): row 4's topic as Avro ({events} events encoded "
          f"under v1 in {enc_s:.2f} s) read under the evolved v2 through "
          f"'format'='avro': {events / avro_s:.0f} events/s against "
          f"{events / raw_s:.0f} through the raw format; all {checked} "
          f"HOP(2 s, 10 s) sums equal the raw run's (and the oracle) bit "
          f"for bit; launches {avro_counts} (raw {raw_counts})")
    return out


def phase_cluster(torch, device: str = "cuda", small: bool = False) -> dict:
    """Phase 23: the control plane and the Avro format. ``device="cpu",
    small=True`` rehearses it at a cut size without a card."""
    if device == "cuda":
        from flink_tpu_torch.stateplane import cuda_build

        cuda_build.build_all()
    big, mid = (10_000_000, 2_000_000) if not small else (600_000, 300_000)
    batch = (1 << 20) if not small else (1 << 16)
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(dir=".") as tmp:
        tmp = os.path.abspath(tmp)
        out["a"] = minicluster_q5(torch, tmp, device, big, batch)
        out["b"] = failover_q5(torch, tmp, device, big, batch)
        out["c"] = savepoints_q5(torch, tmp, device, big, batch)
        out["d"] = ha_q5(torch, tmp, device, mid, batch // 4)
        out["e"] = standalone_q5(torch, tmp, device, mid, batch // 4)
    out["f"] = grpc_shuffle_revenue(torch, device, mid, batch // 2)
    out["g"] = avro_row4(torch, device, 500_000 if not small else 100_000)
    launches = {"exchange_rank": 0, "ordered_fold": 0}
    for part in out.values():
        for k in launches:
            launches[k] += part["launches"][k]
    seconds = time.perf_counter() - t_phase
    print(f"phase 23: {seconds:.1f} s; launches {launches}")
    shown = {**out, "a": {**out["a"], "queries": {
        k: v for k, v in out["a"]["queries"].items() if k != "answers"}}}
    print("cluster " + json.dumps(shown, default=str))
    return {**out, "launches": launches, "seconds": seconds}


#: phase 24's seeds: the clients' keys and the queried keys of 24(e)
SERVE_SEED = 24


def _answers_equal(got, want, what: str) -> int:
    """Answers equal as structures, floats on their raw bits (NaN-aware),
    every scalar of the same Python type; returns the values compared."""
    import struct

    n = 0

    def walk(g, w, path):
        nonlocal n
        if type(g) is not type(w):
            raise AssertionError(f"{what} {path}: {type(g).__name__} vs "
                                 f"{type(w).__name__}")
        if isinstance(w, dict):
            if sorted(g) != sorted(w):
                raise AssertionError(f"{what} {path}: keys {sorted(g)[:6]} "
                                     f"vs {sorted(w)[:6]}")
            for k in w:
                walk(g[k], w[k], f"{path}[{k!r}]")
        elif isinstance(w, (list, tuple)):
            if len(g) != len(w):
                raise AssertionError(f"{what} {path}: {len(g)} vs {len(w)}")
            for i, (a, b) in enumerate(zip(g, w)):
                walk(a, b, f"{path}[{i}]")
        elif isinstance(w, float):
            n += 1
            if struct.pack("<d", g) != struct.pack("<d", w):
                raise AssertionError(f"{what} {path}: {g!r} vs {w!r}")
        else:
            n += 1
            if g != w:
                raise AssertionError(f"{what} {path}: {g!r} vs {w!r}")

    walk(got, want, "")
    return n


def q5_slices(records: int):
    """Per-slice (count, float32 price sum in stream order) of the first
    ``records`` bids: ``[n_slices, AUCTIONS]`` each, slice j ending at
    (j + 1) * SLIDE (``np.add.at`` folds each slice's prices in stream
    order, as the engine's ordered fold does)."""
    from flink_tpu_torch.benchmarks.nexmark import BidSource

    src = BidSource(total_records=records, num_auctions=AUCTIONS,
                    events_per_second_of_eventtime=RATE)
    src.open()
    n_slices = ((records - 1) * 1000 // RATE) // SLIDE + 1
    counts = np.zeros((n_slices, AUCTIONS), np.int64)
    sums = np.zeros((n_slices, AUCTIONS), np.float32)
    max_ts = 0
    while (b := src.poll_batch(1 << 22)) is not None:
        idx = (b.timestamps // SLIDE) * AUCTIONS + b["auction"]
        counts.reshape(-1)[:] += np.bincount(idx, minlength=counts.size)
        np.add.at(sums.reshape(-1), idx, b["price"])
        max_ts = max(max_ts, int(b.timestamps.max()))
    return counts, sums, max_ts


_Q5_SLICES = {}


def q5_slices_cached(records: int):
    if records not in _Q5_SLICES:
        _Q5_SLICES[records] = q5_slices(records)
    return _Q5_SLICES[records]


def live_windows_oracle(records: int, column: str, keys=None):
    """What a point query answers for each auction at the held cut after
    ``records`` bids, by NumPy: the slices still live (their last window,
    ``end + SIZE - SLIDE``, not yet fired by the watermark ``max_ts - 1``),
    each window touching a live slice with the key's bids, its value the
    left fold of those slices in ``slice_ends_for_window`` order (counts:
    an int sum; ``sum_price``: float32 ``((0 + s0) + s1) + ...``). One
    ``{window_end: {column: value}}`` per auction of ``keys`` (default
    every auction)."""
    counts, sums, max_ts = q5_slices_cached(records)
    k = SIZE // SLIDE
    keys = np.arange(AUCTIONS) if keys is None else np.asarray(keys)
    live = [j for j in range(len(counts))
            if (j + 1) * SLIDE + SIZE - SLIDE > max_ts]
    vals = counts if column == "count" else sums
    out = [dict() for _ in range(len(keys))]
    for e in range(min(live), max(live) + k):
        acc = np.zeros(len(keys), vals.dtype)
        hit = np.zeros(len(keys), bool)
        for j in range(e - k + 1, e + 1):
            if j in live:
                m = counts[j, keys] > 0
                acc = np.where(m, acc + vals[j, keys], acc)
                hit |= m
        end = (e + 1) * SLIDE
        cast = int if column == "count" else float
        for i in np.nonzero(hit)[0].tolist():
            out[i][end] = {column: cast(acc[i])}
    return out


def _held_run(torch, env, hold: str, at_cut, device: str, control=None):
    """Run ``env``'s job on a LocalExecutor thread with a control queue
    (``at_cut(control, t0)`` runs once the held source holds); then the
    stream is released and the job finishes. Returns (what ``at_cut``
    returned, the JobExecutionResult, wall s of the whole run)."""
    import queue
    import threading

    from flink_tpu_torch.benchmarks.held import release, wait_held
    from flink_tpu_torch.cluster.local_executor import LocalExecutor

    control = queue.Queue() if control is None else control
    out = {}
    graph = env.get_stream_graph()

    def run():
        try:
            out["result"] = LocalExecutor(env.config).run(
                graph, "serve", control_queue=control)
        except BaseException as e:  # noqa: BLE001 - raised below
            out["error"] = e

    t0 = time.perf_counter()
    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        while True:
            try:
                wait_held(hold, timeout_s=1.0)
                break
            except TimeoutError:
                if not t.is_alive():
                    raise out.get("error") or AssertionError(
                        "the job ended before its source held")
                if time.perf_counter() - t0 > 600:
                    raise
        got = at_cut(control, t0)
    finally:
        release(hold)
        t.join(timeout=600)
    _sync(torch, device)
    if "error" in out:
        raise out["error"]
    return got, out["result"], time.perf_counter() - t0


def _ask(control, req, timeout: float = 120.0):
    control.put(req)
    return req.wait(timeout)


def _query_all(control, op: str, keys, batch: int = 8192):
    """Every key through ``StateQueryBatchRequest``s of ``batch`` keys."""
    from flink_tpu_torch.cluster.local_executor import StateQueryBatchRequest

    keys = list(keys)
    out = []
    for i in range(0, len(keys), batch):
        out.extend(_ask(control, StateQueryBatchRequest(
            op, keys[i:i + batch])))
    return out


def _cut(control, op: str, probe):
    """Settle at the held cut (``benchmarks/held.py``'s ``settle``)."""
    from flink_tpu_torch.benchmarks.held import settle
    from flink_tpu_torch.cluster.local_executor import StateQueryBatchRequest

    return settle(lambda: _ask(control, StateQueryBatchRequest(op, probe)))


Q5_OP, REV_OP = "window_agg(CountAggregate)", "window_agg(SumAggregate)"


def _held_q5_env(device, hold, records, batch, extra=None):
    from flink_tpu_torch.benchmarks.held import HeldBidSource
    from flink_tpu_torch.benchmarks.nexmark import build_q5
    from flink_tpu_torch.connectors.sinks import CollectSink

    env = _q5_env(device, batch, extra)
    sink = CollectSink()
    build_q5(env, HeldBidSource(hold, total_records=records,
                                num_auctions=AUCTIONS,
                                events_per_second_of_eventtime=RATE),
             size_ms=SIZE, slide_ms=SLIDE, device_top_k=TOP_K).sink_to(sink)
    return env, sink


def _held_revenue_env(device, hold, records, batch, conf):
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.held import HeldBidSource
    from flink_tpu_torch.connectors.sinks import CollectSink

    env = StreamExecutionEnvironment(Configuration({
        "execution.micro-batch.size": batch, "execution.device": device,
        **conf}))
    sink = CollectSink()
    build_revenue(env, HeldBidSource(
        hold, total_records=records, num_auctions=AUCTIONS,
        events_per_second_of_eventtime=RATE)).sink_to(sink)
    return env, sink


def serving_q5(torch, tmp: str, device: str, records: int, batch: int,
               clients: int = 16) -> dict:
    """24(a): phase 5's Q5 at P=8 through ``LocalExecutor`` with a
    ``ServingPlane`` bound to the job's control queue and ``clients``
    threads issuing ``lookup_batch`` of 256 auctions (``default_rng(24)``)
    with a 2 ms pause from the first batch to the release (the client
    shape of the reference's row 6, ``tools/bench_suite.py:303-325``);
    the same job without them beside it."""
    import queue
    import threading

    from flink_tpu_torch.metrics.core import quantile_sorted
    from flink_tpu_torch.tenancy.serving import ServingPlane

    def one(with_clients: bool):
        hold = os.path.join(tmp, f"a-{with_clients}")
        env, sink = _held_q5_env(device, hold, records, batch)
        plane = ServingPlane(window_ms=1.0)
        stop = threading.Event()
        errors = []
        lat = {}

        def client(i):
            rng = np.random.default_rng(SERVE_SEED + i)
            while not stop.is_set():
                try:
                    plane.lookup_batch("serve", Q5_OP, rng.integers(
                        0, AUCTIONS, 256).tolist())
                except BaseException as e:  # noqa: BLE001
                    errors.append(e)
                    return
                time.sleep(0.002)

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(clients if with_clients else 0)]

        def at_cut(control, t0):
            from flink_tpu_torch.benchmarks.held import settle

            cut = settle(lambda: plane.lookup_batch(
                "serve", Q5_OP, list(range(256))))
            ingest_s = time.perf_counter() - t0
            lat["clients_s"] = time.perf_counter() - lat.get("start", t0)
            ans = []
            for i in range(0, AUCTIONS, 8192):
                ans.extend(plane.lookup_batch(
                    "serve", Q5_OP, list(range(i, min(i + 8192, AUCTIONS)))))
            stop.set()
            for t in threads:
                t.join(timeout=30)
            return ans, ingest_s, cut

        control = queue.Queue()
        plane.bind_job("serve", control)
        reset_counts()
        lat["start"] = time.perf_counter()
        try:
            for t in threads:
                t.start()
            (ans, ingest_s, _), result, wall = _held_run(
                torch, env, hold, at_cut, device, control)
        finally:
            stop.set()
        counts = read_counts()
        plane.unbind_job("serve")
        if errors:
            raise AssertionError(f"24(a): a client failed: {errors[0]!r}")
        m = plane.metrics()
        lats = sorted(plane._pool.latencies())
        return {"answers": ans, "ingest_s": ingest_s, "wall_s": wall,
                "sink": sink, "counts": counts, "metrics": m,
                "p50_ms": quantile_sorted(lats, 0.5) if lats else 0.0,
                "clients_s": lat["clients_s"]}

    quiet = one(False)
    served = one(True)
    t1 = time.perf_counter()
    want = live_windows_oracle(records, "count")
    oracle_s = time.perf_counter() - t1
    compared = _answers_equal(served["answers"], want, "24(a) at the cut")
    _answers_equal(quiet["answers"], want, "24(a) without clients")
    windows = _stage_check_q5(served["sink"], records, "24(a) after release")
    _stage_check_q5(quiet["sink"], records, "24(a) without clients")
    for run in (served, quiet):
        if device == "cuda" and run["counts"]["exchange_rank"] <= 0:
            raise AssertionError("24(a) ran without launching the rank")
    m = served["metrics"]
    client_lookups = m["lookups_total"]
    out = {"records": records, "clients": clients,
           "events_per_s": records / served["ingest_s"],
           "events_per_s_without_clients": records / quiet["ingest_s"],
           "ratio": quiet["ingest_s"] / served["ingest_s"],
           "lookups_total": client_lookups,
           "lookups_per_s": client_lookups / served["clients_s"],
           "lookup_p50_ms": served["p50_ms"],
           "lookup_p99_ms": m["lookup_p99_ms"],
           "lookups_per_device_batch": m["avg_batch_size"],
           "answered_auctions": sum(1 for a in want if a),
           "values_compared": compared, "windows": windows,
           "oracle_s": oracle_s,
           "launches": {k: served["counts"][k] + quiet["counts"][k]
                        for k in served["counts"]},
           "answers": served["answers"]}
    print(f"phase 24(a): Q5 P=8, {records} bids with {clients} query "
          f"clients: {out['events_per_s']:.0f} events/s to the held cut "
          f"(without clients {out['events_per_s_without_clients']:.0f}, "
          f"ratio {out['ratio']:.3f}); {client_lookups} lookups at "
          f"{out['lookups_per_s']:.0f}/s, p50 {served['p50_ms']:.3f} ms "
          f"p99 {m['lookup_p99_ms']:.3f} ms, {m['avg_batch_size']:.1f} "
          f"lookups per device batch; all {AUCTIONS} auctions' "
          f"{{window_end: count}} at the cut equal the live-slice oracle "
          f"({compared} values); after the release {windows} windows' "
          f"winners equal phase 5's oracle; launches {out['launches']}")
    return out


def _revenue_at_cut(torch, tmp, tag, device, records, batch, conf, keys):
    """Q5-revenue with a held end of stream: (the answers for ``keys`` at
    the cut, the sink, the launches, the answered pairs' residency
    shares, wall s)."""
    from flink_tpu_torch.runtime.operators import WindowAggOperator

    hold = os.path.join(tmp, tag)
    env, sink = _held_revenue_env(device, hold, records, batch, conf)
    rec = EngineRecorder(WindowAggOperator)

    def at_cut(control, t0):
        _cut(control, REV_OP, list(range(64)))
        return _query_all(control, REV_OP, keys), _shares(rec.engines, keys)

    reset_counts()
    try:
        (ans, shares), _, wall = _held_run(torch, env, hold, at_cut, device)
    finally:
        rec.close()
    return ans, sink, read_counts(), shares, wall


def _shares(ops, keys) -> dict:
    """Of the (key, live slice) pairs the engines answer for ``keys``: how
    many were resident on the device, spilled to the host tier, or paged
    out (read at the held cut, read-only)."""
    out = {"resident": 0, "spilled": 0, "paged": 0}
    keys = np.asarray(keys, dtype=np.int64)
    for op in ops:
        w = getattr(op, "windower", None)
        table = getattr(w, "table", None)
        if table is None or not hasattr(table, "query_batch_pairs"):
            continue
        from flink_tpu_torch.state.keygroups import hash_keys_to_i64

        kid = hash_keys_to_i64(keys)
        if hasattr(w, "meta"):
            pairs = [(int(k), int(iv[2])) for k in kid
                     for iv in w.meta.sessions.get(int(k), ())]
            if not pairs:
                continue
            pk = np.asarray([p[0] for p in pairs], dtype=np.int64)
            pn = np.asarray([p[1] for p in pairs], dtype=np.int64)
        else:
            live = np.asarray(table.namespaces, dtype=np.int64)
            pk, pn = np.repeat(kid, len(live)), np.tile(live, len(kid))
        hit = table.index.lookup(pk, pn) >= 0
        found, _ = table.query_batch_pairs(pk, pn)
        out["resident"] += int(hit.sum())
        cold = int((found & ~hit).sum())
        out["paged" if getattr(table, "_paged", False) else "spilled"] += \
            cold
    return out


def serving_revenue(torch, tmp: str, device: str, records: int, batch: int
                    ) -> dict:
    """24(b): Q5-revenue at P=8 (float32 ``.sum("price")``) on the first
    ``records`` bids: every auction's answer at the held cut on the card
    equals the port on the CPU at the same cut bit for bit, and the
    live-slice oracle."""
    keys = list(range(AUCTIONS))
    conf = {"parallelism.default": 8}
    card, sink, counts, _, wall = _revenue_at_cut(
        torch, tmp, "b-card", device, records, batch, conf, keys)
    cpu, _, _, _, cpu_wall = _revenue_at_cut(
        torch, tmp, "b-cpu", "cpu", records, batch, conf, keys)
    compared = _answers_equal(card, cpu, "24(b) card vs CPU")
    _answers_equal(card, live_windows_oracle(records, "sum_price"),
                   "24(b) vs the oracle")
    want, cnt = revenue_oracle_cached(records)
    rows, _ = check_revenue_rows(sink.result(), want, cnt,
                                 "24(b) after release")
    if device == "cuda" and (counts["exchange_rank"] <= 0
                             or counts["ordered_fold"] <= 0):
        raise AssertionError(f"24(b): launches {counts}")
    out = {"records": records, "values_compared": compared, "rows": rows,
           "wall_s": wall, "cpu_wall_s": cpu_wall, "launches": counts,
           "answers": card}
    print(f"phase 24(b): Q5-revenue P=8 on {records} bids: all {AUCTIONS} "
          f"auctions' {{window_end: sum_price}} at the held cut equal on "
          f"the card and the CPU bit for bit and the live-slice oracle "
          f"({compared} values); after the release {rows} fired sums "
          f"equal 22(d)'s oracle; launches {counts}")
    return out


def serving_minicluster(torch, tmp: str, device: str, records: int,
                        batch: int, want, reads=None) -> dict:
    """24(c): 23(a)'s job (two in-process TaskExecutors) with a held end
    of stream, read through ``QueryableStateClient`` in 256-key batches,
    one key through the REST state route and ``cli query``
    (``mc_queries``): the answers equal 24(a)'s. ``reads``: 23(a)'s run's
    (phase 23 runs them at its cut); without them the job runs here."""
    if reads is None:
        from flink_tpu_torch import Configuration
        from flink_tpu_torch.cluster.minicluster import MiniCluster

        hold = os.path.join(tmp, "c")
        env, _ = _held_q5_env(device, hold, records, batch)
        cluster = MiniCluster(Configuration({"rest.port": 0,
                                             "cluster.task-executors": 2,
                                             "heartbeat.interval-ms": 100}))
        try:
            reset_counts()
            t0 = time.perf_counter()
            client = cluster.submit(env, "q5-serve")
            reads = mc_queries(cluster, client, hold, t0)
            st = client.wait(timeout=600)
            _sync(torch, device)
            counts = read_counts()
        finally:
            cluster.shutdown()
        if st["status"] != "FINISHED":
            raise AssertionError(f"24(c): {st}")
        if device == "cuda" and counts["exchange_rank"] <= 0:
            raise AssertionError("24(c) ran without launching the rank")
        run = "its own run"
    else:
        counts = {"exchange_rank": 0, "ordered_fold": 0}   # 23(a)'s count
        run = "23(a)'s run"
    compared = _answers_equal(reads["answers"], want, "24(c) vs 24(a)")
    stats = reads["client_stats"]
    out = {"records": records, "values_compared": compared,
           "lookups_per_s": reads["lookups_per_s"], "client_stats": stats,
           "run": run, "launches": counts}
    print(f"phase 24(c): Q5 P=8 through a MiniCluster ({run}), {records} "
          f"bids: QueryableStateClient read all {AUCTIONS} auctions in "
          f"256-key batches at {reads['lookups_per_s']:.0f} lookups/s (p99 "
          f"{stats['lookup_p99_ms']:.3f} ms a batch), equal to 24(a) "
          f"({compared} values); REST and cli query agree on key "
          f"{reads['key']}; launches {counts}")
    return out


def serving_stage(torch, tmp: str, device: str, records: int, batch: int,
                  want) -> dict:
    """24(d): 22(a)'s Q5-revenue at 4 subtasks (one source subtask, no
    local combiner) with a held end of stream: one
    ``StateQueryBatchRequest`` of every auction fans out to its owning
    subtasks; the answers equal 24(b)'s bit for bit."""
    from flink_tpu_torch.benchmarks.held import release, settle, wait_held
    from flink_tpu_torch.cluster.local_executor import StateQueryBatchRequest
    from flink_tpu_torch.cluster.stage_executor import StageParallelExecutor
    import queue
    import threading

    hold = os.path.join(tmp, "d")
    env, sink = _held_revenue_env(device, hold, records, batch, {
        "execution.stage-parallelism": 4, "execution.local-agg": False,
        "state.slot-table.capacity": 1 << 20})
    control = queue.Queue()
    done = {}
    reset_counts()
    t = threading.Thread(target=lambda: done.setdefault(
        "r", StageParallelExecutor(env.config).run(
            env.get_stream_graph(), "stage-serve", control_queue=control)),
        daemon=True)
    t.start()
    try:
        wait_held(hold, timeout_s=600)
        settle(lambda: _ask(control, StateQueryBatchRequest(
            REV_OP, list(range(256)))), rounds=6)
        t0 = time.perf_counter()
        ans = _ask(control, StateQueryBatchRequest(
            REV_OP, list(range(AUCTIONS))))
        dt = time.perf_counter() - t0
    finally:
        release(hold)
        t.join(timeout=600)
    _sync(torch, device)
    counts = read_counts()
    if "r" not in done:
        raise AssertionError("24(d): the stage job did not finish")
    compared = _answers_equal(ans, want, "24(d) vs 24(b)")
    if device == "cuda" and counts["ordered_fold"] <= 0:
        raise AssertionError("24(d) ran without launching the ordered fold")
    out = {"records": records, "values_compared": compared,
           "query_s": dt, "launches": counts}
    print(f"phase 24(d): Q5-revenue at 4 subtasks, {records} bids: one "
          f"request of all {AUCTIONS} auctions fanned out to the owning "
          f"subtasks in {dt * 1e3:.1f} ms; equal to 24(b) bit for bit "
          f"({compared} values); launches {counts}")
    return out


def _session_at_cut(torch, tmp, tag, device, records, conf, keys):
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.held import HeldDataGenSource
    from flink_tpu_torch.benchmarks.session_profile import (
        ROW5_GAP,
        ROW5_KEYS,
        ROW5_RATE,
        ROW5_SEED,
        ROW5_SETTINGS,
    )
    from flink_tpu_torch.connectors.sinks import DiscardingSink
    from flink_tpu_torch.runtime.operators import WindowAggOperator
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
    from flink_tpu_torch.windowing.assigners import EventTimeSessionWindows

    hold = os.path.join(tmp, tag)
    env = StreamExecutionEnvironment(Configuration({
        **ROW5_SETTINGS, **conf, "execution.device": device}))
    (env.from_source(HeldDataGenSource(hold, records, ROW5_KEYS, ROW5_RATE,
                                       seed=ROW5_SEED),
                     WatermarkStrategy.for_bounded_out_of_orderness(0))
     .key_by("key").window(EventTimeSessionWindows.with_gap(ROW5_GAP))
     .sum("value").sink_to(DiscardingSink()))
    op = "window_agg(SumAggregate)"
    rec = EngineRecorder(WindowAggOperator)
    mesh = conf.get("parallelism.default", 1) > 1

    def at_cut(control, t0):
        _cut(control, op, keys[:256])
        return _query_all(control, op, keys), (
            _mesh_shares if mesh else _shares)(rec.engines, keys)

    reset_counts()
    try:
        (ans, shares), _, _ = _held_run(torch, env, hold, at_cut, device)
    finally:
        rec.close()
    return ans, shares, read_counts()


def _mesh_shares(ops, keys) -> dict:
    """The mesh session engine's (key, session) pairs for ``keys``:
    resident on the planes or paged out."""
    from flink_tpu_torch.state.keygroups import hash_keys_to_i64

    out = {"resident": 0, "spilled": 0, "paged": 0}
    for op in ops:
        w = getattr(op, "windower", None)
        if w is None or not hasattr(w, "indexes"):
            continue
        kid = hash_keys_to_i64(np.asarray(keys))
        pairs = [(int(k), int(iv[2])) for k in kid
                 for iv in w.meta.sessions.get(int(k), ())]
        if not pairs:
            continue
        pk = np.asarray([p[0] for p in pairs], dtype=np.int64)
        pn = np.asarray([p[1] for p in pairs], dtype=np.int64)
        shards = w._route(pk)
        for p in range(w.P):
            sel = shards == p
            hit = int((w.indexes[p].lookup(pk[sel], pn[sel]) >= 0).sum())
            out["resident"] += hit
            out["paged"] += int(sel.sum()) - hit
    return out


def serving_engines(torch, tmp: str, device: str, records: int,
                    session_records: int, batch: int,
                    budget: int = 1 << 17, small: bool = False) -> dict:
    """24(e): the single-device and session engines, card against CPU at
    the held cut, 4,096 keys from ``default_rng(24)``: Q5-revenue at P=1
    in the slot layout under a 1<<17-slot budget (slices spill), then in
    the pane layout (no spill tier there); row 5's sessions at P=1 and
    on the mesh engine at P=8, cut to ``session_records`` records, the
    paged tier evicting."""
    from flink_tpu_torch.benchmarks.session_profile import (
        ROW5_KEYS,
        ROW5_RATE,
        ROW5_SEED,
    )
    from flink_tpu_torch.connectors.sources import DataGenSource

    rng = np.random.default_rng(SERVE_SEED)
    auctions = rng.integers(0, AUCTIONS, 4096).tolist()
    src = DataGenSource(session_records, ROW5_KEYS, ROW5_RATE,
                        seed=ROW5_SEED)
    src.open()
    seen = np.concatenate([np.asarray(b["key"]) for b in iter(
        lambda: src.poll_batch(1 << 20), None)])
    session_keys = rng.choice(seen, 4096, replace=False).tolist()
    out = {"launches": {"exchange_rank": 0, "ordered_fold": 0}}
    cases = [
        ("slots", "revenue", {"parallelism.default": 1,
                              "state.window-layout": "slots",
                              "state.slot-table.capacity": budget,
                              "state.slot-table.max-device-slots": budget}),
        ("panes", "revenue", {"parallelism.default": 1,
                              "state.window-layout": "panes",
                              "state.slot-table.capacity": 1 << 17}),
        ("sessions-p1", "sessions", {}),
        ("sessions-p8", "sessions", {
            "parallelism.default": 8,
            "state.slot-table.capacity": 1 << 16,
            "state.slot-table.max-device-slots": 1 << 16}),
    ]
    for name, kind, conf in cases:
        res = {}
        for i, dev in enumerate((device, "cpu")):
            if kind == "revenue":
                ans, _, counts, shares, _ = _revenue_at_cut(
                    torch, tmp, f"e-{name}-{i}", dev, records, batch, conf,
                    auctions)
            else:
                ans, shares, counts = _session_at_cut(
                    torch, tmp, f"e-{name}-{i}", dev, session_records,
                    conf, session_keys)
            res[i] = (ans, shares, counts)
        ans, shares, counts = res[0]
        compared = _answers_equal(ans, res[1][0],
                                  f"24(e) {name} card vs CPU")
        if shares != res[1][1]:
            raise AssertionError(f"24(e) {name}: shares {shares} vs "
                                 f"{res[1][1]}")
        if kind == "revenue":
            _answers_equal(ans, live_windows_oracle(records, "sum_price",
                                                    auctions),
                           f"24(e) {name} vs the oracle")
        if name == "panes":
            shares = {"resident": None}     # the ring has no spill tier
        total = sum(v for v in shares.values() if v)
        # a rehearsal's cut size may leave nothing cold at the cut
        if not small and name == "slots" and not shares["spilled"]:
            raise AssertionError("24(e) slots: nothing spilled")
        if not small and name.startswith("sessions") and \
                not shares["paged"]:
            raise AssertionError(f"24(e) {name}: nothing paged out")
        if device == "cuda" and counts["ordered_fold"] <= 0:
            raise AssertionError(f"24(e) {name}: no ordered-fold launch")
        for k in out["launches"]:
            out["launches"][k] += counts[k]
        out[name] = {"values_compared": compared, "pairs": total,
                     "shares": {k: (v / total if total and v is not None
                                    else v) for k, v in shares.items()},
                     "launches": counts}
        print(f"phase 24(e) {name}: 4096 keys at the held cut equal on the "
              f"card and the CPU bit for bit ({compared} values); of "
              f"{total} pairs answered {shares}; launches {counts}")
    return out


def serving_hot_cache(answers) -> dict:
    """24(f), host only: prime the native and the Python hot-row cache
    planes with 24(b)'s answers under one generation (``prime_batch``),
    then ``get_many`` / ``get_many_packed`` on every auction: the same
    values in both planes; probe lookups/s of each."""
    from flink_tpu_torch.native import hotcache_available
    from flink_tpu_torch.tenancy.hot_cache import HotRowCache, PrimeDelta
    from flink_tpu_torch.tenancy.hot_cache_native import NativeHotRowCache

    if not hotcache_available():
        raise AssertionError("24(f): the native hotcache did not build")
    kids, uoff, u_ns, u_val = [], [0], [], []
    for kid, ans in enumerate(answers):
        if not ans:
            continue            # no state: a miss in both planes
        kids.append(kid)
        for w, cols in sorted(ans.items()):
            u_ns.append(w)
            u_val.append(cols["sum_price"])
        uoff.append(len(u_ns))
    delta = PrimeDelta(
        keys=np.asarray(kids, np.int64), uoff=np.asarray(uoff, np.int64),
        u_ns=np.asarray(u_ns, np.int64),
        u_cols=[("sum_price", np.asarray(u_val, np.float64))],
        roff=np.zeros(len(kids) + 1, np.int64), r_ns=np.zeros(0, np.int64),
        flags=np.ones(len(kids), np.uint8))
    n = len(answers)
    keys = np.arange(n, dtype=np.int64)
    res, rates, prime_rounds = {}, {}, {}
    from flink_tpu_torch.tenancy.hot_cache_native import ENTRY_CAP as cap
    fitting = {"native": sum(1 for a in answers if a and len(a) <= cap),
               "python": len(kids)}
    for name, make in (("native", lambda: NativeHotRowCache(1 << 18)),
                       ("python", lambda: HotRowCache(1 << 18))):
        c = make()
        # a native table starts small and grows under pressure (a grown
        # table starts empty): re-prime the same generation until it
        # holds every key, as the next publishes would
        for rounds in range(1, 9):
            c.prime_batch("serve", "rev", 1, delta)
            if c.stats()["hot_row_entries"] >= fitting[name]:
                break
        prime_rounds[name] = rounds
        out, miss = [None] * n, []
        t0 = time.perf_counter()
        hits = c.get_many("serve", "rev", keys, 1, out, miss, exact=False)
        dt = time.perf_counter() - t0
        rates[name] = n / dt
        packed = getattr(c, "get_many_packed", None)
        if packed is not None:
            pout, pmiss = [None] * n, []
            t0 = time.perf_counter()
            _, probe = packed("serve", "rev", keys, 1, pout, pmiss,
                              exact=False)
            rates[name + "_packed"] = n / (time.perf_counter() - t0)
            missing = {i for i, _ in pmiss}
            got = [pout[i] if pout[i] is not None or i in missing
                   else probe.materialize(i) for i in range(n)]
            _answers_equal(got, out, f"24(f) {name} packed vs dict")
        res[name] = (out, hits, sorted(i for i, _ in miss))
        if hasattr(c, "close"):
            c.close()
    # the native plane packs at most ENTRY_CAP windows a key: a longer
    # composition is dropped there (counted), a miss, as in the reference
    from flink_tpu_torch.tenancy.hot_cache_native import ENTRY_CAP

    want = [a if a else None for a in answers]
    _answers_equal(res["python"][0], want, "24(f) Python plane vs 24(b)")
    fits = [a if a is not None and len(a) <= ENTRY_CAP else None
            for a in want]
    _answers_equal(res["native"][0], fits, "24(f) native plane vs 24(b)")
    oversize = sum(1 for a in want if a is not None and len(a) > ENTRY_CAP)
    out = {"keys": n, "hits": res["native"][1],
           "python_hits": res["python"][1], "oversize": oversize,
           "prime_rounds": prime_rounds,
           "native_lookups_per_s": rates["native"],
           "native_packed_lookups_per_s": rates.get("native_packed"),
           "python_lookups_per_s": rates["python"]}
    print(f"phase 24(f) (host only): both hot-row cache planes primed with "
          f"24(b)'s answers give 24(b)'s values for all {n} auctions "
          f"(Python plane {res['python'][1]} hits; native "
          f"{res['native'][1]}, the {oversize} compositions of more than "
          f"{ENTRY_CAP} windows dropped there as the reference drops "
          f"them); get_many {rates['native']:.0f} "
          f"lookups/s native ({rates.get('native_packed', 0):.0f} packed), "
          f"{rates['python']:.0f} Python")
    return out


def phase_serving(torch, device: str = "cuda", small: bool = False,
                  mc_reads=None) -> dict:
    """Phase 24: point queries and the serving plane. ``device="cpu",
    small=True`` rehearses it at a cut size without a card. ``mc_reads``:
    23(a)'s reads at its held cut (24(c) checks them in place of a run of
    its own)."""
    if device == "cuda":
        from flink_tpu_torch.stateplane import cuda_build

        cuda_build.build_all()
    big, mid, sess = ((10_000_000, 2_000_000, 1_000_000) if not small
                      else (600_000, 300_000, 200_000))
    batch = (1 << 20) if not small else (1 << 16)
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(dir=".") as tmp:
        tmp = os.path.abspath(tmp)
        a = serving_q5(torch, tmp, device, big, batch)
        b = serving_revenue(torch, tmp, device, mid, batch // 2)
        c = serving_minicluster(torch, tmp, device, big, batch,
                                a.pop("answers"), mc_reads)
        d = serving_stage(torch, tmp, device, mid, batch // 2,
                          b["answers"])
        e = serving_engines(torch, tmp, device, mid, sess, batch // 4,
                            small=small)
        rev_answers = b.pop("answers")
        f = serving_hot_cache(rev_answers)
    out = {"a": a, "b": b, "c": c, "d": d, "e": e, "f": f}
    launches = {"exchange_rank": 0, "ordered_fold": 0}
    for part in (a, b, c, d, e):
        for k in launches:
            launches[k] += part["launches"][k]
    if device == "cuda":
        for part, names in (("a", ("exchange_rank",)),
                            ("b", ("exchange_rank", "ordered_fold")),
                            ("c", ("exchange_rank",) if mc_reads is None
                             else ()),
                            ("d", ("ordered_fold",)),
                            ("e", ("ordered_fold",))):
            for k in names:
                if out[part]["launches"][k] <= 0:
                    raise AssertionError(f"24({part}): no {k} launch")
    seconds = time.perf_counter() - t_phase
    print(f"phase 24: {seconds:.1f} s; launches {launches}")
    print("serving " + json.dumps(out, default=str))
    # 24(b)'s answers at its cut (card == CPU): 25(a) reads them
    return {**out, "launches": launches, "seconds": seconds,
            "rev_answers": rev_answers, "rev_records": mid}


# ------------------------------------------------------------ phase 25

TENANT_QUOTA_ROWS = 1 << 22     # 25(a): above both tenants' resident rows
#: 25(b)'s records a job, cut from the reference's 400,000: the 16 client
#: threads GIL-starve the one scheduler thread (400k took 476.7 s on the
#: card, the card idle); 20,000 is five batches of 4,096 a job (40,000, ten
#: batches, until phase 27 came: 48.6 s of the script)
ROW6_RECORDS = 20_000
TENANCY_CLIENTS = 16


def _publish_totals() -> dict:
    """The flight recorder's ``serving.replica_publish`` spans so far
    (count, total s): every boundary publish of every engine."""
    from flink_tpu_torch.observe import flight_recorder as flight

    return flight.recorder().kind_totals().get(
        "serving.replica_publish", {"count": 0, "total_s": 0.0})


def replica_step_timing(torch, device: str) -> dict:
    """The replica's two torch-op steps (``tenancy/replica.py``
    ``build_replica_steps``) at 25(a)'s Q5 shapes, by CUDA events: the
    publish (clone each ``[8, 1<<17]`` leaf and copy a delta of 1<<16
    slots a shard in) and the gather of a 4,096-lane miss batch a shard;
    the bytes bound beside each (each byte read and written once at
    3.35 TB/s). Not kernels: the times are for the record."""
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.tenancy.replica import build_replica_steps

    P, cap, D, G = 8, 1 << 17, 1 << 16, 4096
    pub, gather = build_replica_steps(make_mesh(P, device), ("int32",))
    rng = np.random.default_rng(25)
    rep = (torch.zeros((P, cap), dtype=torch.int32, device=device),)
    live = (torch.from_numpy(rng.integers(0, 99, (P, cap)).astype(np.int32)
                             ).to(device),)
    slots = torch.from_numpy(np.stack([
        rng.choice(cap, D, replace=False) for _ in range(P)])).to(device)
    gs = torch.from_numpy(rng.integers(0, cap, (P, G))).to(device)
    out = pub(rep, live, slots)
    if not torch.equal(out[0].gather(1, slots), live[0].gather(1, slots)) \
            or not torch.equal(rep[0], torch.zeros_like(rep[0])):
        raise AssertionError("25: the publish step wrote its input or "
                             "dropped a delta row")
    if device != "cuda":
        return {"publish_ms": None, "gather_ms": None}
    pub_ms = cuda_ms(lambda: pub(rep, live, slots), 50)
    gather_ms = cuda_ms(lambda: gather(out, gs), 200)
    pub_bytes = 2 * P * cap * 4 + P * D * (8 + 4 + 4)
    gather_bytes = P * G * (8 + 4 + 4)
    return {"publish_ms": pub_ms,
            "publish_bound_ms": pub_bytes / HBM_BYTES_PER_S * 1e3,
            "gather_ms": gather_ms,
            "gather_bound_ms": gather_bytes / HBM_BYTES_PER_S * 1e3}


def _tenant_jobs(device, tmp, tag, q5_records, rev_records, batch):
    """25(a)'s two tenants with held ends of stream: phase 5's Q5 and
    phase 6's Q5-revenue at P=8, ``serving.replica`` on."""
    rep = {"serving.replica": True}
    hq, hr = os.path.join(tmp, f"{tag}-q5"), os.path.join(tmp, f"{tag}-rev")
    env_q5, sink_q5 = _held_q5_env(device, hq, q5_records, batch, rep)
    env_rev, sink_rev = _held_revenue_env(
        device, hr, rev_records, batch // 2,
        {"parallelism.default": 8, **rep})
    return {"q5": (env_q5, sink_q5, hq, Q5_OP, q5_records),
            "rev": (env_rev, sink_rev, hr, REV_OP, rev_records)}


def _cluster_in_thread(cluster):
    import threading

    out = {}

    def run():
        c0 = time.thread_time()
        try:
            out["results"] = cluster.run(timeout_s=900)
        except BaseException as e:  # noqa: BLE001 - raised by the caller
            out["error"] = e
        finally:
            # the scheduler thread's CPU time: the rest of its wall it
            # waited (the GIL, with clients)
            out["scheduler_cpu_s"] = time.thread_time() - c0

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, out


def tenancy_pair(torch, cluster, device, tmp, tag, q5_records, rev_records,
                 batch, clients: int, full: bool = True) -> dict:
    """One run of 25(a)'s two tenants on ``cluster``: ``clients`` threads
    issue ``lookup_batch_packed`` of 256 auctions (2 ms pause) until the
    cut; at the cut every auction's replica answer and the live engine's
    (``StateQueryBatchRequest`` on the job's control queue) are taken
    (``full=False``: a twelfth of the auctions, through the serving
    plane); then the holds are released and the jobs finish."""
    import threading

    from flink_tpu_torch.benchmarks.held import release
    from flink_tpu_torch.metrics.core import quantile_sorted
    from flink_tpu_torch.tenancy.quotas import TenantQuota

    jobs = _tenant_jobs(device, tmp, tag, q5_records, rev_records, batch)
    for name, (env, _, _, _, _) in jobs.items():
        cluster.submit(env, f"{tag}-{name}",
                       quota=TenantQuota(max_resident_rows=TENANT_QUOTA_ROWS))
    names = [f"{tag}-{n}" for n in jobs]
    ops = {f"{tag}-{n}": jobs[n][3] for n in jobs}
    stop = threading.Event()
    errors, lat, gens = [], [], [0]
    # replica staleness per tenant, sampled only while it ingests: from
    # the start to its cut (a source holding its end of stream for the
    # other tenant's cut is idle, not lagging)
    stale = {n: [] for n in jobs}
    ingesting = set(jobs)

    def client(i):
        rng = np.random.default_rng(SERVE_SEED + i)
        while not stop.is_set():
            job = names[i % 2]
            try:
                t0 = time.perf_counter()
                cluster.lookup_batch_packed(
                    job, ops[job], rng.integers(0, AUCTIONS, 256).tolist())
                lat.append((time.perf_counter() - t0) * 1e3)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
                return
            time.sleep(0.002)

    def sampler():
        while not stop.is_set():
            gens[0] = max(gens[0], cluster.serving.replica_generations())
            for n in list(ingesting):
                ad = cluster.serving._replicas.get((f"{tag}-{n}", ops[
                    f"{tag}-{n}"]))
                if ad is not None and ad.ready():
                    stale[n].append(ad.plane.staleness_ms())
            time.sleep(0.01)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    threads.append(threading.Thread(target=sampler, daemon=True))
    pub0 = _publish_totals()
    reset_counts()
    t0 = time.perf_counter()
    th, out = _cluster_in_thread(cluster)
    for t in threads:
        t.start()
    ingest_s, replica, live = {}, {}, {}
    try:
        # each tenant's cut as soon as its source holds (the other keeps
        # its quanta meanwhile): ingest time = start to settled cut
        pending = dict(jobs)
        while pending:
            for name in list(pending):
                hold, op = pending[name][2], pending[name][3]
                if not os.path.exists(os.path.join(hold, "held")):
                    continue
                ingesting.discard(name)
                _cut(cluster.jobs[f"{tag}-{name}"].control, op,
                     list(range(64)))
                ingest_s[name] = time.perf_counter() - t0
                del pending[name]
            if not th.is_alive():
                raise out.get("error") or AssertionError(
                    f"25(a) {tag}: the cluster ended before the cut")
            if time.perf_counter() - t0 > 600:
                raise AssertionError(f"25(a) {tag}: no cut in 600 s")
            time.sleep(0.005)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        clients_s = time.perf_counter() - t0
        lookups = cluster.serving.lookups_total()
        hit_rate = cluster.serving.hot_row_hit_rate()
        keys = list(range(AUCTIONS))
        plane_keys = keys[::12]
        for name, (_, _, hold, op, _) in jobs.items():
            job = f"{tag}-{name}"
            # every auction off the sealed generation (the bound adapter:
            # one gather and one copy back a batch), then a twelfth of
            # them through the serving plane (hot cache and workers)
            if full:
                ad = cluster.serving._replicas[(job, op)]
                t1 = time.perf_counter()
                rep = []
                for i in range(0, AUCTIONS, 1 << 15):
                    rep.extend(ad.lookup_batch(keys[i:i + (1 << 15)])[0])
                replica[name] = rep
                replica[name + "_s"] = time.perf_counter() - t1
            replica[name + "_plane"] = (
                plane_keys, cluster.lookup_batch(job, op, plane_keys))
            live[name] = dict(zip(
                keys if full else plane_keys,
                _query_all(cluster.jobs[job].control, op,
                           keys if full else plane_keys)))
    finally:
        stop.set()
        for _, _, hold, _, _ in jobs.values():
            release(hold)
        th.join(timeout=600)
    _sync(torch, device)
    counts = read_counts()
    if "error" in out:
        raise out["error"]
    if errors:
        raise AssertionError(f"25(a) {tag}: a client failed: {errors[0]!r}")
    for job, res in out["results"].items():
        if isinstance(res, BaseException):
            raise AssertionError(f"25(a) {job} failed: {res!r}")
    lat.sort()
    for s in stale.values():
        s.sort()
    pub1 = _publish_totals()
    publishes = pub1["count"] - pub0["count"]
    return {"publishes": publishes,
            "scheduler_cpu_s": out.get("scheduler_cpu_s"),
            "scheduler_wall_s": time.perf_counter() - t0,
            "publish_ms_mean": ((pub1["total_s"] - pub0["total_s"]) * 1e3
                                / publishes if publishes else 0.0),
            "jobs": jobs, "ingest_s": ingest_s, "replica": replica,
            "live": live, "counts": counts, "lookups": lookups,
            "clients_s": clients_s, "hit_rate": hit_rate,
            "generations": gens[0],
            "p50_ms": quantile_sorted(lat, 0.5) if lat else 0.0,
            "p99_ms": quantile_sorted(lat, 0.99) if lat else 0.0,
            "staleness_p99_ms": {n: (quantile_sorted(s, 0.99) if s
                                     else 0.0) for n, s in stale.items()},
            "staleness_samples": {n: len(s) for n, s in stale.items()},
            "violations": {j: cluster.jobs[j].ledger.quota_violations
                           for j in names}}


def tenancy_slice(torch, tmp: str, device: str, q5_records: int,
                  rev_records: int, batch: int, prior=None) -> dict:
    """25(a): the slice at full width (see the module doc). ``prior``:
    phase 24's results (24(a)'s legacy-path p99 and 24(b)'s card == CPU
    answers at the same 2M-bid cut), else the CPU answers are made here."""
    from flink_tpu_torch.tenancy.program_cache import PROGRAM_CACHE
    from flink_tpu_torch.tenancy.session_cluster import SessionCluster

    cluster = SessionCluster(serving_workers=2)
    served = tenancy_pair(torch, cluster, device, tmp, "a", q5_records,
                          rev_records, batch, TENANCY_CLIENTS)
    # the second pair: fresh jobs on the warm cluster, no clients
    PROGRAM_CACHE.reset_stats()
    quiet = tenancy_pair(torch, cluster, device, tmp, "w", q5_records,
                         rev_records, batch, 0, full=False)
    warm = {j: PROGRAM_CACHE.stats_for(j) for j in ("w-q5", "w-rev")}
    misses = {j: s["misses"] for j, s in warm.items()}
    if any(misses.values()) or not all(s["hits"] for s in warm.values()):
        # hits > 0 too: a job whose builds escaped its job_scope would
        # read zeros and pass the miss gate vacuously
        raise AssertionError(f"25(a): program cache on the warm cluster "
                             f"{warm} (want 0 misses and a hit a job)")
    if served["generations"] < 2:
        raise AssertionError(f"25(a): replica generations "
                             f"{served['generations']} < 2")
    if served["hit_rate"] <= 0.0:
        raise AssertionError("25(a): the hot-row cache served no hit")
    for run in (served, quiet):
        if any(run["violations"].values()):
            raise AssertionError(f"25(a): quota violations "
                                 f"{run['violations']}")
    # the CPU port at the same cut
    if prior is not None and prior.get("rev_records") == rev_records:
        # 24(b)'s answers at the same cut, equal on the card and the CPU
        cpu_rev = prior["rev_answers"]
    else:
        cpu_rev, _, _, _, _ = _revenue_at_cut(
            torch, tmp, "a-cpu", "cpu", rev_records, batch // 2,
            {"parallelism.default": 8}, list(range(AUCTIONS)))
    cpu_q5 = live_windows_oracle(q5_records, "count")
    compared = 0
    keys = list(range(AUCTIONS))
    for n, cpu in (("q5", cpu_q5), ("rev", cpu_rev)):
        rep = served["replica"][n]
        compared += _answers_equal(rep, [served["live"][n][k] for k in keys],
                                   f"25(a) {n} replica vs live")
        compared += _answers_equal(rep, cpu, f"25(a) {n} replica vs the "
                                   "CPU port")
    for run, label in ((served, "with clients"), (quiet, "without")):
        for n, cpu in (("q5", cpu_q5), ("rev", cpu_rev)):
            ks, got = run["replica"][n + "_plane"]
            want = [run["live"][n][k] for k in ks]
            compared += _answers_equal(
                got, want, f"25(a) {n} through the serving plane vs live, "
                f"{label}")
            compared += _answers_equal(
                want, [cpu[k] for k in ks],
                f"25(a) {n} live vs the CPU port, {label}")
        _stage_check_q5(run["jobs"]["q5"][1], q5_records,
                        f"25(a) Q5 sink, {label}")
        want, cnt = revenue_oracle_cached(rev_records)
        check_revenue_rows(run["jobs"]["rev"][1].result(), want, cnt,
                           f"25(a) revenue sink, {label}")
        if device == "cuda" and (run["counts"]["exchange_rank"] <= 0
                                 or run["counts"]["ordered_fold"] <= 0):
            raise AssertionError(f"25(a) {label}: launches {run['counts']}")
    legacy_p99 = None
    if prior is not None and "a" in prior:
        legacy_p99 = prior["a"].get("lookup_p99_ms")
    out = {
        "q5_records": q5_records, "rev_records": rev_records,
        "clients": TENANCY_CLIENTS,
        "events_per_s": {n: served["jobs"][n][4] / served["ingest_s"][n]
                         for n in ("q5", "rev")},
        "events_per_s_without_clients": {
            n: quiet["jobs"][n][4] / quiet["ingest_s"][n]
            for n in ("q5", "rev")},
        "lookups": served["lookups"],
        "lookups_per_s": served["lookups"] / served["clients_s"],
        "lookup_p50_ms": served["p50_ms"],
        "lookup_p99_ms": served["p99_ms"],
        "legacy_p99_ms_24a": legacy_p99,
        "staleness_p99_ms": served["staleness_p99_ms"],
        "hot_row_hit_rate": served["hit_rate"],
        "generations": served["generations"],
        "cache_warm": warm,
        "staleness_samples": served["staleness_samples"],
        "replica_read_s": {n: served["replica"][n + "_s"]
                           for n in ("q5", "rev")},
        "serving_plane_keys": len(served["replica"]["q5_plane"][0]),
        "values_compared": compared,
        "publishes": {"with_clients": served["publishes"],
                      "without": quiet["publishes"]},
        "scheduler_cpu_wall_s": {
            "with_clients": (served["scheduler_cpu_s"],
                             served["scheduler_wall_s"]),
            "without": (quiet["scheduler_cpu_s"],
                        quiet["scheduler_wall_s"])},
        "publish_ms_mean": {"with_clients": served["publish_ms_mean"],
                            "without": quiet["publish_ms_mean"]},
        "steps": replica_step_timing(torch, device),
        "launches": {k: served["counts"][k] + quiet["counts"][k]
                     for k in served["counts"]},
    }
    print(f"phase 25(a): Q5 ({q5_records} bids) and Q5-revenue "
          f"({rev_records} bids) at P=8 on one SessionCluster with "
          f"{TENANCY_CLIENTS} clients: events/s {out['events_per_s']} "
          f"(without clients {out['events_per_s_without_clients']}); "
          f"{served['lookups']} lookups at {out['lookups_per_s']:.0f}/s, "
          f"p50 {served['p50_ms']:.3f} ms p99 {served['p99_ms']:.3f} ms "
          f"(24(a)'s legacy path p99 {legacy_p99} ms, for the record), "
          f"replica staleness p99 while ingesting "
          f"{served['staleness_p99_ms']} ms, "
          f"{served['generations']} generations, hit rate "
          f"{served['hit_rate']:.4f}; every auction's replica answer at "
          f"the cut equals the live engine and the CPU port ({compared} "
          f"values); sinks equal the oracles; program cache on the warm "
          f"cluster {warm}; {out['publishes']} boundary publishes, "
          f"{out['publish_ms_mean']} ms each on average; the scheduler "
          f"thread's CPU and wall s {out['scheduler_cpu_wall_s']}; "
          f"replica steps "
          f"{out['steps']}; launches {out['launches']}")
    return out


def _sorted_rows(rows):
    return sorted(rows, key=lambda r: (r.get("key"), r.get("window_end")))


def tenancy_row6(torch, device: str, records: int = ROW6_RECORDS) -> dict:
    """25(b): BASELINE row 6 at the reference's settings
    (``flink_tpu_torch/benchmarks/serving.py``); the measured jobs' sinks
    equal the same jobs on the CPU bit for bit."""
    from flink_tpu_torch.benchmarks import serving
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.tenancy.session_cluster import SessionCluster

    reset_counts()
    t0 = time.perf_counter()
    r = serving.row6(device, records=records, clients=TENANCY_CLIENTS)
    wall = time.perf_counter() - t0
    _sync(torch, device)
    counts = read_counts()
    if r["failures"]:
        raise AssertionError(f"25(b): {r['failures']}")
    cpu = SessionCluster()
    sinks = {j: CollectSink() for j in ("job-2", "job-3")}
    for j, s in sinks.items():
        cpu.submit(serving.pipeline(s, "cpu", records), j)
    cpu.run(timeout_s=600)
    compared = 0
    for j, s in sinks.items():
        compared += _answers_equal(_sorted_rows(r["rows"][j]),
                                   _sorted_rows(s.rows()),
                                   f"25(b) {j} card vs CPU")
    if device == "cuda" and (counts["exchange_rank"] <= 0
                             or counts["ordered_fold"] <= 0):
        raise AssertionError(f"25(b): launches {counts}")
    r.pop("rows")
    out = {**r, "wall_s": wall, "values_compared": compared,
           "launches": counts}
    print(f"phase 25(b): BASELINE row 6 ({records} records a job, "
          f"{TENANCY_CLIENTS} clients x 256 keys, 2 ms pause): "
          f"{r['lookups_per_s']:.0f} lookups/s (the reference's floor "
          f"{serving.REF_MIN_LOOKUPS_PER_S:.0f}, set on other hardware), "
          f"call p50 {r['call_p50_ms']:.3f} ms p99 {r['call_p99_ms']:.3f} "
          f"ms (the reference's budget {serving.REF_P99_BUDGET_MS} ms), "
          f"staleness p99 {r['staleness_p99_ms']:.1f} ms, hit rate "
          f"{r['hot_row_hit_rate']:.4f}, {r['replica_generations']} "
          f"generations, program-cache misses {r['program_cache_misses']}, "
          f"the scheduler thread {r['scheduler_cpu_s']:.2f} s CPU of "
          f"{r['elapsed_s']:.2f} s; "
          f"sinks equal the CPU bit for bit ({compared} values) in "
          f"{wall:.1f} s; launches {counts}")
    return out


def tenancy_row9(tmp: str) -> dict:
    """25(c): BASELINE row 9 (``flink_tpu_torch/benchmarks/serving_mp.py``):
    2 frontend processes, 4,096 keys, 256-key batches, 2,000 batches
    each, priming every 25 ms."""
    from flink_tpu_torch.benchmarks import serving_mp

    t0 = time.perf_counter()
    r = serving_mp.row9(frontends=2, keys=4096, batch=256, batches=2000,
                        prime_interval_ms=25.0, root=tmp)
    if r["failures"]:
        raise AssertionError(f"25(c): {r['failures']}")
    print(f"phase 25(c): BASELINE row 9: 2 frontends "
          f"{r['lookups_per_s']:.0f} lookups/s aggregate, one frontend "
          f"{r['one_frontend_lookups_per_s']:.0f}/s, the owner's one-process "
          f"loop {r['single_proc_lookups_per_s']:.0f}/s; hit rate "
          f"{r['hit_rate']:.4f}, {r['torn_retries']} torn retries, "
          f"{r['torn_surfaced']} surfaced, parity mismatches "
          f"{r['parity_mismatches']}, {r['generations']} generations, "
          f"{time.perf_counter() - t0:.1f} s")
    return {**r, "launches": {"exchange_rank": 0, "ordered_fold": 0}}


def tenancy_chaos(torch, tmp: str, device: str, steps: int = 16,
                  per_step: int = 1 << 16, keys: int = 20_000) -> dict:
    """25(d): ``run_crash_restore_verify_multi`` with two mesh window jobs
    at P=8 (tumbling 2 s float32 Sum) serving 256 keys after every step;
    job a crashes at its 5th serving burst (a non-recoverable
    ``serving.lookup`` fault, mid-burst) and restores from its own
    checkpoints; job b is never restored."""
    from flink_tpu_torch.chaos import harness
    from flink_tpu_torch.chaos.injection import FaultPlan, FaultRule
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.sharded_windower import MeshWindowEngine
    from flink_tpu_torch.windowing.aggregates import SumAggregate
    from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows
    from flink_tpu_torch.windowing.windower import SliceSharedWindower

    def stream(seed):
        rng = np.random.default_rng(seed)
        out, t = [], 0
        for _ in range(steps):
            k = rng.integers(0, keys, per_step).astype(np.int64)
            v = rng.random(per_step).astype(np.float32)
            ts = t + np.sort(rng.integers(0, 1000, per_step))
            t += 1000
            out.append((k, v, ts, t - 1500))
        return out

    mesh = make_mesh(8, device)
    asg = TumblingEventTimeWindows.of(2000)
    oracle_counts = {}

    def mk_engine():
        if not oracle_counts:
            oracle_counts.update(read_counts())
            reset_counts()
        return MeshWindowEngine(asg, SumAggregate("v"), mesh,
                                capacity_per_shard=1 << 14)

    def mk_oracle():
        return SliceSharedWindower(asg, SumAggregate("v"), capacity=1 << 17,
                                   spill={"device": "cpu"})

    plan = FaultPlan(rules=[FaultRule(pattern="serving.lookup", nth=5,
                                      where={"job": "a"})])
    serve = np.random.default_rng(SERVE_SEED).integers(0, keys, 256)
    reset_counts()
    t0 = time.perf_counter()
    reports = harness.run_crash_restore_verify_multi(
        make_engines={"a": mk_engine, "b": mk_engine},
        make_oracles={"a": mk_oracle, "b": mk_oracle},
        steps_by_job={"a": stream(1), "b": stream(2)}, plan=plan, seed=25,
        ckpt_root=os.path.join(tmp, "d-chaos"), checkpoint_every=2,
        serve_keys={"a": serve.tolist(), "b": serve.tolist()},
        rel_tol=0.0, abs_tol=0.0)
    wall = time.perf_counter() - t0
    _sync(torch, device)
    counts = read_counts()
    ra, rb = reports["a"], reports["b"]
    if ra.crashes != 1 or ra.restores < 1 or rb.crashes or rb.restores:
        raise AssertionError(f"25(d): a {ra.signature()}, b "
                             f"{rb.signature()}")
    if ra.diverged or rb.diverged:
        raise AssertionError("25(d): committed output diverged")
    if device == "cuda" and (counts["exchange_rank"] <= 0
                             or counts["ordered_fold"] <= 0):
        raise AssertionError(f"25(d): launches {counts}")
    out = {"steps": steps, "records_per_job": steps * per_step,
           "a": ra.signature(), "b": rb.signature(),
           "windows": {"a": ra.windows, "b": rb.windows},
           "restore_ms": ra.restore_ms, "wall_s": wall, "launches": counts}
    print(f"phase 25(d): two mesh window jobs at P=8, {steps} steps of "
          f"{per_step} records each; job a crashed mid-serving-burst and "
          f"restored ({ra.restores} restore, {ra.restore_ms} ms), job b "
          f"never restored; committed windows equal each job's fault-free "
          f"oracle ({ra.windows} and {rb.windows}); {wall:.1f} s; "
          f"launches {counts}")
    return out


def phase_tenancy(torch, device: str = "cuda", small: bool = False,
                  prior=None) -> dict:
    """Phase 25: multi-tenancy (see the module doc). ``device="cpu",
    small=True`` rehearses it at a cut size without a card; ``prior``:
    phase 24's results."""
    if device == "cuda":
        from flink_tpu_torch.stateplane import cuda_build

        cuda_build.build_all()
    # 25(a)'s Q5 at 2M bids (10M until phase 27 came: the whole script
    # passed 1,000 s, and its runs with 16 clients took ~45 s of it)
    q5, rev, row6 = ((2_000_000, 2_000_000, ROW6_RECORDS) if not small
                     else (600_000, 300_000, 20_000))
    batch = (1 << 20) if not small else (1 << 16)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=".") as tmp:
        tmp = os.path.abspath(tmp)
        a = tenancy_slice(torch, tmp, device, q5, rev, batch, prior)
        b = tenancy_row6(torch, device, row6)
        c = tenancy_row9(tmp)
        d = tenancy_chaos(torch, tmp, device,
                          per_step=(1 << 16) if not small else (1 << 12))
    out = {"a": a, "b": b, "c": c, "d": d}
    launches = {"exchange_rank": 0, "ordered_fold": 0}
    for part in (a, b, c, d):
        for k in launches:
            launches[k] += part["launches"][k]
    seconds = time.perf_counter() - t_phase
    print(f"phase 25: {seconds:.1f} s; launches {launches}")
    print("tenancy " + json.dumps(out, default=str))
    return {**out, "launches": launches, "seconds": seconds}


# ---------------------------------------------------------------- phase 26

#: 26(a)'s records: row 5c at 2M of its 4M (the reference's mesh-session
#: depth), cut to keep the whole script under 950 s
ZIPF_RECORDS = 2_000_000
#: 26(b)'s Q5 bids, micro-batch, and the batches after which a rescale
#: request is queued (to 4 shards, then back to 8)
SCALE_Q5_RECORDS, SCALE_Q5_BATCH, SCALE_Q5_PLAN = 4_000_000, 1 << 18, \
    {4: 4, 10: 8}
#: 26(e)'s destination counts (what a reshard or a rebalance gives D)
SCALE_RANK_DS = (2, 3, 4, 7, 8)


def _row_key(r):
    return tuple(sorted((k, v.item() if hasattr(v, "item") else v)
                        for k, v in r.items()))


def _batch_rows(batches):
    """Every row of fired batches as a sorted list of tuples, floats by
    their bits (``np.float32`` columns viewed as uint32)."""
    out = []
    for b in batches:
        names = sorted(b.names())
        cols = []
        for n in names:
            c = np.asarray(b[n])
            if c.dtype == np.float32:
                c = c.view(np.uint32)
            elif c.dtype == np.float64:
                c = c.view(np.uint64)
            cols.append(c.tolist())
        out.extend(zip(*cols))
    out.sort()
    return out


def scaleout_zipf(torch, device: str, records: int) -> dict:
    """26(a): BASELINE row 5c (``benchmarks/mesh_sessions.py --zipf``):
    the uniform control, the Zipf(1.1) run with the skew ladder live, and
    the Zipf run's exact splits and watermarks replayed without the
    ladder: every fired (key, start, end, sum) bit-identical."""
    from flink_tpu_torch.benchmarks import mesh_sessions as ms

    ms.load_libraries(device)  # builds outside the timed runs
    reset_counts()
    t0 = time.perf_counter()
    line = ms.run_zipf_row(records, device, check=True)
    wall = time.perf_counter() - t0
    _sync(torch, device)
    counts = read_counts()
    skew = line["skew"]
    if not line["bit_identical_to_unsplit"]:
        raise AssertionError("26(a): the Zipf run's fires differ from the "
                             "unsplit, unrebalanced run")
    if device == "cuda" and (counts["exchange_rank"] <= 0
                             or counts["ordered_fold"] <= 0):
        raise AssertionError(f"26(a): launches {counts}")
    print(f"phase 26(a): row 5c, {records} records, Zipf(1.1) keys: "
          f"{line['events_per_s']:.0f} events/s against the uniform "
          f"control's {line['uniform_events_per_s']:.0f} (ratio "
          f"{line['skew_recovery_fraction']:.3f}) and the same Zipf splits "
          f"without the ladder's {line['zipf_unsplit_events_per_s']:.0f}; "
          f"{skew['rebalances']} "
          f"live rebalances moving {skew['groups_moved']} key groups (the "
          f"last handoff {skew['handoff_s'] * 1e3:.1f} ms), "
          f"{skew['keys_split']} keys split {skew['hot_keys']}, "
          f"{skew['salted_records']} salted records, "
          f"{skew['salted_fires']} salted fires; load imbalance "
          f"{skew['imbalance_contiguous']:.3f} on the contiguous layout, "
          f"{skew['imbalance_live']:.3f} on the live table; "
          f"{line['fired_rows']} fired rows bit-identical to the unsplit "
          f"run; fire p99 {line['fire_latency_ms']['p99']:.1f} ms; "
          f"{wall:.1f} s for the three runs; launches {counts}")
    return {**line, "wall_s": wall, "launches": counts}


def _q5_rescaled(device: str, records: int, batch: int, plan: dict):
    """Q5 at P=8 through ``LocalExecutor`` (source pumps off, so a
    request queued as the source hands out batch k is served at the
    boundary after it): ``plan`` = {batch -> new shard count}. Returns
    (sink, handoff reports, wall s)."""
    import queue

    from flink_tpu_torch.benchmarks.nexmark import BidSource, build_q5
    from flink_tpu_torch.cluster.local_executor import (
        LocalExecutor,
        RescaleRequest,
    )
    from flink_tpu_torch.connectors.sinks import CollectSink

    control = queue.Queue()
    reqs = []

    class Queueing(BidSource):
        polled = 0

        def poll_batch(self, n):
            b = super().poll_batch(n)
            self.polled += 1
            if self.polled in plan:
                reqs.append(RescaleRequest(plan[self.polled]))
                control.put(reqs[-1])
            return b

    env = _q5_env(device, batch, {"execution.pipeline.in-flight-batches": 0})
    sink = CollectSink()
    build_q5(env, Queueing(total_records=records, num_auctions=AUCTIONS,
                           events_per_second_of_eventtime=RATE),
             size_ms=SIZE, slide_ms=SLIDE, device_top_k=TOP_K).sink_to(sink)
    t0 = time.perf_counter()
    LocalExecutor(env.config).run(env.get_stream_graph(), "q5-rescale",
                                  control_queue=control)
    wall = time.perf_counter() - t0
    return sink, [r.wait(timeout=60) for r in reqs], wall


def _ramp_source():
    """tools/autoscale_smoke.py's load ramp as a source: steps of 1,500 /
    6,000 / 1,500 records over 6,000 keys (gap-100 sessions), one step a
    poll, integer-valued float32 values."""
    from flink_tpu_torch.connectors.sources import Source
    from flink_tpu_torch.core.records import RecordBatch

    class Ramp(Source):
        PHASES = [1500] * 3 + [6000] * 4 + [1500] * 4

        def __init__(self):
            rng = np.random.default_rng(23)
            self.steps = []
            for s, n in enumerate(self.PHASES):
                keys = rng.integers(0, 6000, n).astype(np.int64)
                vals = rng.integers(1, 6, n).astype(np.float32)
                ts = np.sort(rng.integers(s * 80, s * 80 + 60, n)).astype(
                    np.int64)
                self.steps.append((keys, vals, ts))
            self.pos = 0

        def snapshot_position(self):
            return {"pos": self.pos}

        def restore_position(self, pos):
            self.pos = int(pos["pos"])

        def poll_batch(self, max_records):
            if self.pos >= len(self.steps):
                return None
            keys, vals, ts = self.steps[self.pos]
            self.pos += 1
            return RecordBatch.from_pydict({"key": keys, "v": vals},
                                           timestamps=ts)

    return Ramp()


def _ramp_job(device: str, autoscale: bool):
    """The ramp's session job at P=2 (gap 100, float32 Sum, 1,024 rows a
    shard: the paged tier); with ``autoscale`` the executor's controller
    runs on a FAKE clock with scripted signals (one second and the ramp's
    busy share — load / peak — a batch), as tools/autoscale_smoke.py
    drives it: 2 -> 4 on the ramp-up, 4 -> 2 on the ramp-down."""
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.autoscale.controller import SignalSample
    from flink_tpu_torch.cluster.local_executor import LocalExecutor
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
    from flink_tpu_torch.windowing.assigners import EventTimeSessionWindows

    conf = {"parallelism.default": 2, "execution.device": device,
            "execution.micro-batch.size": 8192,
            "execution.pipeline.in-flight-batches": 0,
            "state.slot-table.capacity": 1 << 14,
            "state.slot-table.max-device-slots": 1024}
    if autoscale:
        conf.update({"autoscale.enabled": True, "autoscale.interval-ms": 0,
                     "autoscale.cooldown-ms": 2000,
                     "autoscale.utilization-target": 0.5,
                     "autoscale.hysteresis": 0.25,
                     "autoscale.min-shards": 2, "autoscale.max-shards": 4})
    env = StreamExecutionEnvironment(Configuration(conf))
    src = _ramp_source()
    sink = CollectSink()
    (env.from_source(src, WatermarkStrategy.for_bounded_out_of_orderness(20))
     .key_by("key").window(EventTimeSessionWindows.with_gap(100)).sum("v")
     .sink_to(sink))
    holder = {}

    class Scripted(LocalExecutor):
        def _setup_autoscale(self, nodes, job_group, pumps, watchdog=None):
            ctl = super()._setup_autoscale(nodes, job_group, pumps,
                                           watchdog)
            if ctl is None:
                return None

            def clock():
                return float(src.pos)

            def sample():
                seen = src.steps[:src.pos]
                return SignalSample(
                    records_total=float(sum(len(s[0]) for s in seen)),
                    busy_ms_total=sum(min(len(s[0]) / 6000.0, 1.0) * 1000.0
                                      for s in seen),
                    shard_resident_rows=ctl.engine_rows())

            target = next(n.operator for n in nodes.values()
                          if n.operator is not None and getattr(
                              n.operator, "supports_live_rescale", False))
            ctl.engine_rows = target.shard_resident_rows
            ctl._clock = ctl.policy._clock = clock
            ctl.sample_fn = sample
            holder["ctl"] = ctl
            return ctl

    t0 = time.perf_counter()
    res = Scripted(env.config).run(env.get_stream_graph(), "ramp")
    return sink, res, holder.get("ctl"), time.perf_counter() - t0


def scaleout_q5(torch, device: str, records: int, batch: int) -> dict:
    """26(b): Q5 at P=8 rescaled live by ``RescaleRequest`` to 4 shards
    and back to 8, bit-identical to the uninterrupted run (and to phase
    5's oracle); then the load ramp with ``autoscale.enabled``: 2 -> 4 ->
    2 logical shards, at least two live handoffs, rows equal the run
    without the autoscaler (exact: integer-valued float32)."""
    reset_counts()
    sink, reps, wall = _q5_rescaled(device, records, batch, SCALE_Q5_PLAN)
    _sync(torch, device)
    counts = read_counts()
    clean, _, clean_wall = _q5_rescaled(device, records, batch, {})
    got = sorted(_row_key(r) for r in sink.rows())
    if got != sorted(_row_key(r) for r in clean.rows()):
        raise AssertionError("26(b): the rescaled Q5 differs from the "
                             "uninterrupted run")
    windows = _stage_check_q5(sink, records, "26(b) Q5 rescaled")
    path = [(r["from"], r["to"]) for r in reps]
    if path != [(8, 4), (4, 8)] or not all(r["rows_moved"] for r in reps):
        raise AssertionError(f"26(b): handoffs {reps}")
    if device == "cuda" and counts["exchange_rank"] <= 0:
        raise AssertionError(f"26(b): launches {counts}")
    reset_counts()
    ramp_sink, ramp_res, ctl, ramp_wall = _ramp_job(device, True)
    _sync(torch, device)
    ramp_counts = read_counts()
    plain_sink, _, _, _ = _ramp_job(device, False)
    auto = ramp_res.metrics.get("autoscale") or {}
    ramp_path = auto.get("path", [])
    if (2, 4) not in ramp_path or (4, 2) not in ramp_path \
            or auto.get("live_handoffs", 0) < 2:
        raise AssertionError(f"26(b): the ramp's autoscale {auto}")
    if _batch_rows(ramp_sink.batches) != _batch_rows(plain_sink.batches):
        raise AssertionError("26(b): the autoscaled ramp's rows differ from "
                             "the run without the autoscaler")
    if device == "cuda" and (ramp_counts["exchange_rank"] <= 0
                             or ramp_counts["ordered_fold"] <= 0):
        raise AssertionError(f"26(b) ramp: launches {ramp_counts}")
    out = {"q5_records": records, "handoffs": reps, "q5_wall_s": wall,
           "q5_uninterrupted_wall_s": clean_wall,
           "q5_events_per_s": records / wall,
           "q5_uninterrupted_events_per_s": records / clean_wall,
           "windows": windows, "ramp_path": ramp_path,
           "ramp_handoff_ms": auto.get("handoff_ms"),
           "ramp_rows": len(ramp_sink.rows()), "ramp_wall_s": ramp_wall,
           "launches": {k: counts[k] + ramp_counts[k] for k in counts}}
    print(f"phase 26(b): Q5 at P=8 on {records} bids, RescaleRequest 8 -> 4 "
          f"after batch {min(SCALE_Q5_PLAN)} and 4 -> 8 after batch "
          f"{max(SCALE_Q5_PLAN)}: handoffs "
          + ", ".join(f"{r['from']}->{r['to']} {r['seconds'] * 1e3:.1f} ms "
                      f"({r['rows_moved']} rows moved)" for r in reps)
          + f"; {records / wall:.0f} events/s against "
          f"{records / clean_wall:.0f} uninterrupted; rows bit-identical "
          f"to the uninterrupted run, {windows} windows equal the oracle; "
          f"autoscale.enabled on the fake-clock ramp: path {ramp_path}, "
          f"{auto.get('live_handoffs')} live handoffs "
          f"({auto.get('handoff_ms')} ms), {out['ramp_rows']} rows equal "
          f"the run without the autoscaler; launches {out['launches']}")
    return out


def _interval_stream(steps: int, n: int, keys: int, seed: int = 4):
    rng = np.random.default_rng(seed)
    out = []
    for step in range(steps):
        for side in (0, 1):
            ks = rng.integers(0, keys, n).astype(np.int64)
            ts = step * 100 + rng.integers(0, 100, n).astype(np.int64)
            vs = rng.integers(0, 1000, n).astype(np.float32)
            out.append((side, {"__key_id__": ks, "v" if side == 0 else "w":
                               vs, "__ts__": ts}, step * 100 - 200))
    return out


def scaleout_joins_cep(torch, device: str, small: bool) -> dict:
    """26(c): the interval join (16 steps of two sides) and the mesh CEP
    engine (tools/cep_smoke.py's 3-stage pattern) at P=8, each resharded
    8 -> 4 mid-stream: their outputs equal their runs without a reshard
    (as sorted rows, bit for bit: a reshard changes the shard order rows
    leave in)."""
    from flink_tpu_torch.cep.mesh_engine import MeshCepEngine
    from flink_tpu_torch.core.records import RecordBatch
    from flink_tpu_torch.joins import MeshIntervalJoinEngine

    n, keys = (1 << 15, 50_000) if not small else (2048, 5000)
    stream = _interval_stream(16, n, keys)
    out = {"launches": {"exchange_rank": 0, "ordered_fold": 0}}
    joined = {}
    for resh in (True, False):
        eng = MeshIntervalJoinEngine(-20, 20, num_shards=8, device=device)
        rows = []
        if resh:
            reset_counts()
        t0 = time.perf_counter()
        for i, (side, c, wm) in enumerate(stream):
            if resh and i == len(stream) // 2:
                rep = eng.reshard(4)
                out["join_handoff"] = rep
            rows += eng.process_batch(RecordBatch(c), side)
            rows += eng.on_watermark(wm)
        rows += eng.on_watermark(1 << 40)
        _sync(torch, device)
        if resh:
            out["join_wall_s"] = time.perf_counter() - t0
            c1 = read_counts()
            for k in c1:
                out["launches"][k] += c1[k]
        joined[resh] = _batch_rows(rows)
    if joined[True] != joined[False] or not joined[True]:
        raise AssertionError("26(c): the resharded join differs from the "
                             "run without a reshard")
    cep_n, cep_keys = (1 << 15, 20_000) if not small else (2048, 2000)
    pattern = _cep_patterns()["seq3_skip_past"]
    rng = np.random.default_rng(11)
    steps, ts = [], 0
    for _ in range(16):
        k = rng.integers(0, cep_keys, cep_n).astype(np.int64)
        v = rng.integers(0, 9, cep_n).astype(np.int64)
        tss = ts + np.sort(rng.integers(0, 30, cep_n)).astype(np.int64)
        ts += 25
        steps.append((k, v, tss, ts - 5))
    matched = {}
    for resh in (True, False):
        eng = MeshCepEngine(pattern, key_field="k", num_shards=8,
                            device=device, capacity_per_shard=1 << 16)
        rows = []
        if resh:
            reset_counts()
        t0 = time.perf_counter()
        for i, (k, v, tss, wm) in enumerate(steps):
            if resh and i == len(steps) // 2:
                out["cep_handoff"] = eng.reshard(4)
            rows += eng.process_batch(RecordBatch.from_pydict(
                {"k": k, "v": v, "__key_id__": k}, timestamps=tss))
            rows += eng.on_watermark(wm)
        rows += eng.on_watermark(1 << 40)
        _sync(torch, device)
        if resh:
            out["cep_wall_s"] = time.perf_counter() - t0
            c1 = read_counts()
            for kk in c1:
                out["launches"][kk] += c1[kk]
        matched[resh] = _batch_rows(rows)
    if matched[True] != matched[False] or not matched[True]:
        raise AssertionError("26(c): the resharded CEP differs from the run "
                             "without a reshard")
    if device == "cuda" and out["launches"]["exchange_rank"] <= 0:
        raise AssertionError(f"26(c): launches {out['launches']}")
    out.update(join_rows=len(joined[True]), cep_matches=len(matched[True]))
    jh, ch = out["join_handoff"], out["cep_handoff"]
    print(f"phase 26(c): interval join at P=8 ({16 * 2 * n} rows) resharded "
          f"8 -> 4 mid-stream in {jh['seconds'] * 1e3:.1f} ms "
          f"({jh['rows_moved']} rows moved): {len(joined[True])} joined "
          f"rows equal the run without a reshard; mesh CEP at P=8 "
          f"({16 * cep_n} events) resharded 8 -> 4 in "
          f"{ch['seconds'] * 1e3:.1f} ms ({ch['rows_moved']} rows moved): "
          f"{len(matched[True])} matches equal; launches {out['launches']}")
    return out


def scaleout_tenancy(torch, tmp: str, device: str, records: int) -> dict:
    """26(d): a ``SessionCluster`` with two held Q5 jobs at P=2 (the
    replica on) and the arbiter ticking every 5 ms: at least one live
    rescale served, no rescale error; at the held cut every auction's
    replica answer equals the live engine's; each job's rows equal its
    solo run (exact: counts)."""
    from flink_tpu_torch.benchmarks.held import release
    from flink_tpu_torch.benchmarks.nexmark import BidSource, build_q5
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.tenancy.arbiter import ShardArbiter
    from flink_tpu_torch.tenancy.session_cluster import SessionCluster

    conf = {"parallelism.default": 2, "serving.replica": True}
    batch = 1 << 17
    cluster = SessionCluster(arbiter=ShardArbiter(8),
                             arbitrate_every_s=0.005)
    jobs = {}
    for name in ("x", "y"):
        hold = os.path.join(tmp, f"scale-{name}")
        env, sink = _held_q5_env(device, hold, records, batch, conf)
        cluster.submit(env, name)
        jobs[name] = (sink, hold)
    reset_counts()
    t0 = time.perf_counter()
    th, out = _cluster_in_thread(cluster)
    keys = list(range(0, AUCTIONS, 7))
    compared = 0
    try:
        _until(lambda: all(os.path.exists(os.path.join(h, "held"))
                           for _, h in jobs.values())
               or not th.is_alive(), 600, "26(d)'s holds")
        _until(lambda: sum(j.rescales_served for j in cluster.jobs.values())
               >= 1 or not th.is_alive(), 120, "26(d)'s first rescale")
        for name in jobs:
            job = cluster.jobs[name]
            _cut(job.control, Q5_OP, list(range(64)))
            live = _query_all(job.control, Q5_OP, keys)
            rep = cluster.lookup_batch(name, Q5_OP, keys)
            compared += _answers_equal(rep, live,
                                       f"26(d) {name} replica vs live")
        # the arbiter stops before the streams end: a request it posts
        # as a job terminates would be failed by the ending job
        cluster.arbitrate_every_s = 0.0
        time.sleep(0.05)
        _until(lambda: all(j._pending_rescale is None
                           or j._pending_rescale._done.is_set()
                           for j in cluster.jobs.values()), 120,
               "26(d)'s last rescale")
    finally:
        for _, h in jobs.values():
            release(h)
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    _sync(torch, device)
    counts = read_counts()
    if "error" in out:
        raise out["error"]
    served = {n: j.rescales_served for n, j in cluster.jobs.items()}
    errors = {n: j.rescale_errors for n, j in cluster.jobs.items()}
    if sum(served.values()) < 1 or any(errors.values()):
        raise AssertionError(
            f"26(d): rescales served {served}, errors {errors} "
            + repr({n: j.last_rescale_error
                    for n, j in cluster.jobs.items()}))
    for name, (sink, _) in jobs.items():
        env = _q5_env(device, batch, {"parallelism.default": 2})
        solo = CollectSink()
        build_q5(env, BidSource(total_records=records, num_auctions=AUCTIONS,
                                events_per_second_of_eventtime=RATE),
                 size_ms=SIZE, slide_ms=SLIDE,
                 device_top_k=TOP_K).sink_to(solo)
        env.execute("solo")
        if sorted(_row_key(r) for r in sink.rows()) != \
                sorted(_row_key(r) for r in solo.rows()):
            raise AssertionError(f"26(d): job {name}'s rows differ from its "
                                 "solo run")
    if device == "cuda" and counts["exchange_rank"] <= 0:
        raise AssertionError(f"26(d): launches {counts}")
    shards = {n: int(j.handle.stateful_operators()[0].windower.P)
              if j.handle is not None else None
              for n, j in cluster.jobs.items()}
    print(f"phase 26(d): SessionCluster with two Q5 jobs ({records} bids "
          f"each, P=2 at submit) and the arbiter ticking every 5 ms: "
          f"rescales served {served}, errors {errors}; replica answers at "
          f"the held cut equal the live engine's ({compared} values); each "
          f"job's rows equal its solo run; {wall:.1f} s; launches {counts}")
    return {"served": served, "errors": errors, "values_compared": compared,
            "final_shards": shards, "wall_s": wall, "launches": counts}


def scaleout_rank(torch, device: str, small: bool) -> dict:
    """26(e): the rank kernel against ``exchange_rank_flat_plain`` on the
    destination columns a rebalanced plane gives it: R=8 source chunks of
    C=131,072 Zipf(1.1) keys, routed by a ``KeyGroupAssignment`` that the
    ``RebalancePolicy`` moved off the contiguous layout at each D (so the
    destinations are skewed and non-contiguous), the padded lanes at D.
    Max abs err must be 0 at every D. These comparison launches are not
    counted."""
    from flink_tpu_torch.autoscale import RebalancePolicy
    from flink_tpu_torch.parallel.load import ShardLoadAccountant
    from flink_tpu_torch.state.keygroups import KeyGroupAssignment
    from flink_tpu_torch.stateplane.rank import (
        exchange_rank_flat,
        exchange_rank_flat_plain,
        rank,
    )

    R, C = (8, 131072) if not small else (8, 4096)
    rng = np.random.default_rng(26)
    keys = ((rng.zipf(1.1, R * C) - 1) % 10_000_000).astype(np.int64)
    rows = []
    before = rank.launches
    for D in SCALE_RANK_DS:
        acc = ShardLoadAccountant(D, 128, top_k=64)
        acc.note_batch(keys)
        cur = KeyGroupAssignment.contiguous(D, 128)
        plan = RebalancePolicy(imbalance_trigger=1.0, hysteresis=0.0,
                               cooldown_s=0.0, max_moves=32).plan(acc, cur)
        asg = plan.assignment or cur
        dst = asg.shard_of_keys(keys, 128).astype(np.int32).reshape(R, C)
        dst[:, C - C // 16:] = D  # the padded tail of each chunk
        counts = np.stack([np.bincount(r, minlength=D + 1)[:D]
                           for r in dst])
        W = int(counts.max())
        d = torch.from_numpy(dst).to(device)
        got = exchange_rank_flat(d, D, W)
        want = exchange_rank_flat_plain(d, D, W)
        err = float((got - want).abs().max().item())
        if err != 0.0:
            raise AssertionError(f"26(e): rank kernel differs at D={D}: "
                                 f"max abs err {err}")
        ms = cuda_ms(lambda: exchange_rank_flat(d, D, W), 50) \
            if device == "cuda" else None
        rows.append({"D": D, "W": W, "moves": len(plan.moves),
                     "contiguous": asg.is_contiguous,
                     "imbalance": [plan.imbalance_before,
                                   plan.imbalance_after],
                     "max_abs_err": err, "ms": ms})
    print("phase 26(e): the rank kernel on rebalanced Zipf destinations at "
          f"R={R} C={C}: "
          + "; ".join(f"D={r['D']} W={r['W']} ({r['moves']} moves, "
                      f"imbalance {r['imbalance'][0]:.2f} -> "
                      f"{r['imbalance'][1]:.2f}) err {r['max_abs_err']}"
                      + (f" {r['ms']:.4f} ms" if r["ms"] is not None
                         else "") for r in rows)
          + f"; {rank.launches - before} comparison launches (not counted)")
    return {"cases": rows}


def phase_scaleout(torch, device: str = "cuda", small: bool = False) -> dict:
    """Phase 26: scale-out and skew (see the module doc).
    ``device="cpu", small=True`` rehearses it at a cut size without a
    card."""
    if device == "cuda":
        from flink_tpu_torch.stateplane import cuda_build

        cuda_build.build_all()
    t_phase = time.perf_counter()
    a = scaleout_zipf(torch, device, ZIPF_RECORDS if not small else 200_000)
    b = scaleout_q5(torch, device,
                    SCALE_Q5_RECORDS if not small else 300_000,
                    SCALE_Q5_BATCH if not small else 1 << 14)
    c = scaleout_joins_cep(torch, device, small)
    with tempfile.TemporaryDirectory(dir=".") as tmp:
        d = scaleout_tenancy(torch, os.path.abspath(tmp), device,
                             1_000_000 if not small else 100_000)
    e = scaleout_rank(torch, device, small)
    launches = {"exchange_rank": 0, "ordered_fold": 0}
    for part in (a, b, c, d):
        for k in launches:
            launches[k] += part["launches"][k]
    seconds = time.perf_counter() - t_phase
    out = {"a": a, "b": b, "c": c, "d": d, "e": e}
    print(f"phase 26: {seconds:.1f} s; launches {launches}")
    print("scaleout " + json.dumps(out, default=str))
    return {**out, "launches": launches, "seconds": seconds}


# --------------------------------------------------------------- phase 27

#: 27(a)/(b)'s Q5 bids, 27(a)'s Q5-revenue bids, 27(b)'s session records,
#: 27(c)'s row-8 records (4x the bench row's 262,144)
POD_Q5_RECORDS = 4_000_000
POD_REVENUE_RECORDS = 2_000_000
POD_SESSION_RECORDS = 1_000_000
ROW8_RECORDS = 1 << 20
#: 27(d)'s host-loss stream (8 batches of 65,536) and held Q5 bids
POD_LOSS_RECORDS = 1 << 19


class _EngineLog:
    """Records the mesh window engines a run opens (to read their
    two-level traffic after ``env.execute()``)."""

    def __init__(self):
        from flink_tpu_torch.parallel.sharded_windower import (
            MeshWindowEngine,
        )

        self.cls, self.engines = MeshWindowEngine, []
        self._init = MeshWindowEngine.__init__
        log = self

        def init(eng, *a, **k):
            log._init(eng, *a, **k)
            log.engines.append(eng)

        MeshWindowEngine.__init__ = init

    def close(self):
        self.cls.__init__ = self._init

    def traffic(self) -> dict:
        out = {"rows_intra_host": 0, "rows_cross_host": 0,
               "exchange2_batches": 0, "stage1_rank": 0, "stage2_rank": 0,
               "stage2_fold": 0}
        for e in self.engines:
            tr = e._exchange2_traffic
            if tr is None:
                continue
            for k, v in {**tr.as_dict(), **tr.launches}.items():
                out[k] += v
        return out


def _pod_job(torch, build, device, extra, records):
    """``build`` at P=8 through ``env.execute()`` with ``extra`` keys:
    (sink rows, seconds, launches, the engines' two-level traffic)."""
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.nexmark import BidSource
    from flink_tpu_torch.connectors.sinks import CollectSink

    env = StreamExecutionEnvironment(Configuration({
        "parallelism.default": 8, "execution.micro-batch.size": 1 << 20,
        "execution.device": device, **extra}))
    sink = CollectSink()
    build(env, BidSource(total_records=records, num_auctions=AUCTIONS,
                         events_per_second_of_eventtime=RATE)).sink_to(sink)
    log = _EngineLog()
    try:
        reset_counts()
        t0 = time.perf_counter()
        env.execute()
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
    finally:
        log.close()
    return sink.result(), seconds, counts, log.traffic()


def _q5_build(env, src):
    from flink_tpu_torch.benchmarks.nexmark import build_q5

    return build_q5(env, src, size_ms=SIZE, slide_ms=SLIDE,
                    device_top_k=TOP_K)


def _sorted_bits(batch) -> dict:
    """A sink's result as {column: array}, every column on its bits and
    the rows in one order (a lexsort over all columns): two results are
    the same rows, bit for bit, when these are equal."""
    cols = {}
    for name in sorted(batch.names()):
        a = np.asarray(batch[name])
        cols[name] = a.view(f"u{a.dtype.itemsize}") if a.dtype.kind == "f" \
            else a
    order = np.lexsort(tuple(cols.values())) if cols else []
    return {k: v[order] for k, v in cols.items()}


def _same_rows(a, b) -> bool:
    x, y = _sorted_bits(a), _sorted_bits(b)
    return x.keys() == y.keys() and all(
        np.array_equal(x[k], y[k]) for k in x)


def pod_two_level(torch, device: str, q5_records: int,
                  rev_records: int) -> dict:
    """27(a): Q5 and Q5-revenue at P=8 with ``shuffle.hosts=2``."""
    q5_res, q5_s, q5_counts, q5_tr = _pod_job(
        torch, _q5_build, device, {"shuffle.hosts": 2}, q5_records)

    class _S:
        def rows(self):
            return q5_res.to_rows()

    windows = _stage_check_q5(_S(), q5_records, "phase 27(a) Q5 2x4")
    if q5_tr["exchange2_batches"] <= 0 or q5_tr["rows_cross_host"] <= 0:
        raise AssertionError(f"phase 27(a): Q5 did not run the two-level "
                             f"exchange ({q5_tr})")
    rev, rev_s, rev_counts, rev_tr = _pod_job(
        torch, build_revenue, device, {"shuffle.hosts": 2}, rev_records)
    flat, flat_s, flat_counts, _ = _pod_job(torch, build_revenue, device,
                                            {}, rev_records)
    if not _same_rows(rev, flat):
        raise AssertionError("phase 27(a): Q5-revenue at 2x4 differs from "
                             "the flat run")
    if device == "cuda":
        for what, c, stage_fold in (("Q5", q5_counts, None),
                                    ("revenue", rev_counts,
                                     rev_tr["stage2_fold"])):
            if c["exchange_rank"] <= 0 or (stage_fold is not None
                                           and stage_fold <= 0):
                raise AssertionError(f"phase 27(a): {what} launches {c}, "
                                     "the stage-2 fold did not launch")
    out = {"q5": {"records": q5_records, "seconds": q5_s,
                  "events_per_s": q5_records / q5_s, "windows": windows,
                  "traffic": q5_tr, "launches": q5_counts},
           "revenue": {"records": rev_records, "seconds": rev_s,
                       "flat_seconds": flat_s, "rows": len(rev),
                       "traffic": rev_tr, "launches": rev_counts,
                       "flat_launches": flat_counts}}
    print(f"phase 27(a): Q5 at 2x4 over {q5_records} bids in {q5_s:.3f} s "
          f"= {q5_records / q5_s:.0f} events/s, {windows} windows equal "
          f"the oracle; traffic {q5_tr}; Q5-revenue at 2x4 over "
          f"{rev_records} bids in {rev_s:.3f} s (flat {flat_s:.3f} s), "
          f"{len(rev)} rows equal the flat run bit for bit; traffic "
          f"{rev_tr}")
    out["launches"] = {k: q5_counts[k] + rev_counts[k] + flat_counts[k]
                       for k in q5_counts}
    out["q5_rows"] = q5_res
    return out


def _session_modes(torch, device: str, records: int, mode: str):
    """Row 5's stream (``benchmarks/mesh_sessions.py``: uniform keys over
    10M, 400k events/s, gap 2 s, 1<<16 rows a shard) on the P=8 session
    engine in ``mode``, a watermark after every batch: the fired batches
    and the launches."""
    from flink_tpu_torch.benchmarks import mesh_sessions as ms
    from flink_tpu_torch.core.records import KEY_ID_FIELD, RecordBatch
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.sharded_sessions import MeshSessionEngine
    from flink_tpu_torch.windowing.aggregates import SumAggregate

    eng = MeshSessionEngine(ms.GAP_MS, SumAggregate("v"),
                            make_mesh(8, device),
                            capacity_per_shard=ms.BUDGET_PER_SHARD,
                            max_device_slots=ms.BUDGET_PER_SHARD,
                            shuffle_mode=mode)
    fired = []
    reset_counts()
    t0 = time.perf_counter()
    for keys, ts in ms.stream_batches(records):
        eng.process_batch(RecordBatch.from_pydict(
            {KEY_ID_FIELD: keys, "v": np.ones(len(keys), np.float32)},
            timestamps=ts))
        fired.extend(eng.on_watermark(int(ts[-1]) - ms.GAP_MS))
    fired.extend(eng.on_watermark(1 << 60))
    if device == "cuda":
        torch.cuda.synchronize()
    return fired, time.perf_counter() - t0, read_counts(), eng


def pod_host_mode(torch, device: str, q5_records: int, sess_records: int,
                  q5_rows) -> dict:
    """27(b): ``shuffle.mode=host`` on Q5 and on mesh sessions at P=8,
    each equal to its device-mode run."""
    rows, q5_s, q5_counts, _ = _pod_job(
        torch, _q5_build, device, {"shuffle.mode": "host"}, q5_records)
    if not _same_rows(rows, q5_rows):
        raise AssertionError("phase 27(b): Q5 in host mode differs from "
                             "27(a)'s device-mode rows")
    host, host_s, host_counts, heng = _session_modes(
        torch, device, sess_records, "host")
    dev, dev_s, dev_counts, deng = _session_modes(
        torch, device, sess_records, "device")
    n = _batches_equal("phase 27(b) sessions host vs device", host, dev)
    if heng.spill_counters() != deng.spill_counters():
        raise AssertionError("phase 27(b): spill counters differ")
    if device == "cuda" and (host_counts["ordered_fold"] <= 0
                             or dev_counts["exchange_rank"] <= 0):
        raise AssertionError(f"phase 27(b): launches host {host_counts}, "
                             f"device {dev_counts}")
    print(f"phase 27(b): Q5 in host mode over {q5_records} bids in "
          f"{q5_s:.3f} s = {q5_records / q5_s:.0f} events/s, rows equal "
          f"27(a)'s; mesh sessions P=8 over {sess_records} records: host "
          f"mode {host_s:.3f} s, device mode {dev_s:.3f} s, {n} sessions "
          f"equal bit for bit; spill {heng.spill_counters()}")
    return {"q5_seconds": q5_s, "sessions": n, "host_seconds": host_s,
            "device_seconds": dev_s,
            "launches": {k: q5_counts[k] + host_counts[k] + dev_counts[k]
                         for k in q5_counts}}


def pod_row8(torch, device: str, records: int) -> dict:
    """27(c): BASELINE row 8 through ``benchmarks/multiproc.py``: two
    processes on the one card, exchanging over gloo, and the kill leg.
    Their kernels launch in the child processes, whose counts are not
    read here."""
    from flink_tpu_torch.benchmarks.multiproc import Shape, run_row8

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=".") as tmp:
        row = run_row8(Shape(records), device=device, kill=True,
                       timeout=300, workdir=tmp)
    row.pop("artifacts")
    row["seconds"] = time.perf_counter() - t0
    print(f"phase 27(c): row 8, {records} records, 2 processes x 4 "
          f"shards on one card over gloo: {row['value']:.0f} events/s "
          f"(one process {row['single_proc_events_per_s']:.0f}), "
          f"{row['cross_host_rows']} rows crossed, "
          f"{row['gloo_bytes_sent']} bytes through gloo, route "
          f"{row['route_ms_per_batch']:.3f} ms a batch; kill leg "
          f"restored {row['kill_restored_units']} units "
          f"{row['kill_restored_ranges']}, replayed "
          f"{row['kill_replayed']} records; union bit-identical; "
          f"{row['seconds']:.1f} s")
    print("row8 " + json.dumps(row))
    return row


def pod_host_loss(torch, device: str, records: int) -> dict:
    """27(d): ``host.lost`` at 2x4 on the mesh window engine (rows equal
    the fault-free run's), then ``LookupRouter`` over the two hosts of a
    held Q5 window engine."""
    from flink_tpu_torch.benchmarks.nexmark import BidSource
    from flink_tpu_torch.benchmarks.shard_loss import watched
    from flink_tpu_torch.chaos.harness import run_shard_loss_verify
    from flink_tpu_torch.chaos.injection import FaultPlan, FaultRule
    from flink_tpu_torch.parallel.mesh import HostTopology, make_mesh
    from flink_tpu_torch.parallel.sharded_windower import MeshWindowEngine
    from flink_tpu_torch.tenancy.frontend import LookupRouter
    from flink_tpu_torch.windowing.aggregates import (
        CountAggregate,
        SumAggregate,
    )
    from flink_tpu_torch.windowing.assigners import (
        SlidingEventTimeWindows,
        TumblingEventTimeWindows,
    )
    from flink_tpu_torch.windowing.windower import SliceSharedWindower

    rng = np.random.default_rng(27)
    steps = []
    per = 1 << 16
    for s in range(max(records // per, 4)):
        steps.append((rng.integers(0, 1 << 20, per).astype(np.int64),
                      rng.random(per).astype(np.float32),
                      rng.integers(s * 80, s * 80 + 60, per).astype(np.int64),
                      (s - 1) * 80))

    def engine():
        return MeshWindowEngine(TumblingEventTimeWindows.of(160),
                                SumAggregate("v"), make_mesh(8, device),
                                capacity_per_shard=1 << 18,
                                host_topology=HostTopology(2, 4))

    def oracle():
        return SliceSharedWindower(TumblingEventTimeWindows.of(160),
                                   SumAggregate("v"), capacity=1 << 21,
                                   spill={"device": device})

    reports = {}
    with tempfile.TemporaryDirectory(dir=".") as tmp:
        for tag, rules in (("clean", []),
                           ("lost", [FaultRule(pattern="host.lost", nth=6,
                                               where={"host": 1})])):
            # the counts go to 0 when the first 2x4 engine is built, after
            # the oracle's run: they are the engine's launches alone
            reports[tag] = run_shard_loss_verify(
                watched(engine, {}), oracle, steps, FaultPlan(rules=rules),
                seed=7, ckpt_root=os.path.join(tmp, tag), checkpoint_every=2)
            reports[tag + "_counts"] = read_counts()
    lost, clean = reports["lost"], reports["clean"]
    if lost.diverged or lost.hosts_lost != 1 or lost.shards_lost != 4:
        raise AssertionError(f"phase 27(d): host loss {lost.signature()}")
    if lost.committed != clean.committed:
        raise AssertionError("phase 27(d): the host-loss run's rows differ "
                             "from the fault-free run's")
    # LookupRouter over a held Q5 count engine at 2x4: both hosts' state
    # is on this card, so each host's entry point is the engine's own
    # query_batch, and the router's answers must equal it key for key
    held = MeshWindowEngine(SlidingEventTimeWindows.of(SIZE, SLIDE),
                            CountAggregate(), make_mesh(8, device),
                            capacity_per_shard=1 << 17,
                            host_topology=HostTopology(2, 4))
    src = BidSource(total_records=records, num_auctions=AUCTIONS,
                    events_per_second_of_eventtime=RATE)
    src.open()
    from flink_tpu_torch.core.records import KEY_ID_FIELD

    reset_counts()
    while (b := src.poll_batch(1 << 18)) is not None:
        held.process_batch(b.with_column(
            KEY_ID_FIELD, np.asarray(b["auction"], np.int64)))
    router_counts = read_counts()
    router = LookupRouter(2, 4, held.max_parallelism, local_host=0,
                          lookup_fns={h: (lambda job, op, keys:
                                          held.query_batch(keys))
                                      for h in (0, 1)},
                          key_id_fn=lambda k: np.asarray(k, np.int64))
    keys = np.arange(0, AUCTIONS, 7, dtype=np.int64)
    got = router.lookup_batch("q5", "count", keys.tolist())
    want = held.query_batch(keys)
    if got != want or not any(got):
        raise AssertionError("phase 27(d): LookupRouter answers differ "
                             "from the engine's query_batch")
    m = router.metrics()
    if m["router_local_keys"] <= 0 or m["router_remote_keys"] <= 0:
        raise AssertionError(f"phase 27(d): router {m}")
    print(f"phase 27(d): host.lost at 2x4 on the window engine over "
          f"{len(steps)} batches: {lost.signature()}, rows equal the "
          f"fault-free run's; LookupRouter over {len(keys)} Q5 keys of a "
          f"held 2x4 engine equal its query_batch: {m}")
    launches = {k: reports["lost_counts"][k] + reports["clean_counts"][k]
                + router_counts[k] for k in router_counts}
    return {"signature": lost.signature(), "router": m,
            "recovery_ms": lost.shard_loss_recovery_ms,
            "launches": launches}


def pod_rank(torch, device: str) -> dict:
    """27(e): the rank kernel against its plain version at the two-level
    exchange's shapes: stage 1 (D = 4 local indices) and stage 2 (D = 2
    hosts) on Q5's first 1<<20 bids staged at 2x4, 27(a)'s widths."""
    from flink_tpu_torch.benchmarks.nexmark import BidSource
    from flink_tpu_torch.parallel.exchange2 import (
        stage1_route,
        stage_two_level_exchange,
    )
    from flink_tpu_torch.parallel.mesh import HostTopology
    from flink_tpu_torch.parallel.shuffle import shard_records
    from flink_tpu_torch.stateplane.rank import (
        exchange_rank_flat,
        exchange_rank_flat_plain,
        rank,
    )

    topo = HostTopology(2, 4)
    src = BidSource(total_records=1 << 20, num_auctions=AUCTIONS,
                    events_per_second_of_eventtime=RATE)
    src.open()
    b = src.poll_batch(1 << 20)
    shards = shard_records(np.asarray(b["auction"], np.int64), 8, 128)
    dst, (slots,), w1, w2 = stage_two_level_exchange(
        shards, topo, columns=[np.arange(len(shards), dtype=np.int32)],
        fills=[0])
    before = rank.launches
    d = torch.from_numpy(dst).to(device).view(8, -1)
    dl = torch.where(d < 8, d % 4, torch.full_like(d, 4)).contiguous()
    d2 = stage1_route(topo, torch.from_numpy(dst).to(device),
                      [torch.from_numpy(slots).to(device)], [0], w1)[0]
    dh = torch.where(d2 < 8, d2 // 4, torch.full_like(d2, 2)).contiguous()
    rows = []
    for stage, col, D, W in ((1, dl, 4, w1), (2, dh, 2, w2)):
        got = exchange_rank_flat(col, D, W)
        want = exchange_rank_flat_plain(col, D, W)
        err = float((got - want).abs().max().item())
        if err != 0.0:
            raise AssertionError(f"27(e): stage {stage} rank differs: "
                                 f"max abs err {err}")
        ms = cuda_ms(lambda: exchange_rank_flat(col, D, W), 50) \
            if device == "cuda" else None
        rows.append({"stage": stage, "R": col.shape[0], "C": col.shape[1],
                     "D": D, "W": W, "max_abs_err": err, "ms": ms})
    print("phase 27(e): the rank kernel at the two-level shapes: "
          + "; ".join(f"stage {r['stage']} R={r['R']} C={r['C']} D={r['D']}"
                      f" W={r['W']} err {r['max_abs_err']}"
                      + (f" {r['ms']:.4f} ms" if r["ms"] is not None
                         else "") for r in rows)
          + f"; {rank.launches - before} comparison launches (not counted)")
    return {"cases": rows}


def phase_pod(torch, device: str = "cuda", small: bool = False) -> dict:
    """Phase 27: the pod (see the module doc). ``device="cpu",
    small=True`` rehearses it at a cut size without a card."""
    if device == "cuda":
        from flink_tpu_torch.stateplane import cuda_build

        cuda_build.build_all()
    t_phase = time.perf_counter()
    parts = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        parts[name] = round(time.perf_counter() - t0, 1)
        return out

    q5_n = POD_Q5_RECORDS if not small else 300_000
    a = timed("a", pod_two_level, torch, device, q5_n,
              POD_REVENUE_RECORDS if not small else 200_000)
    b = timed("b", pod_host_mode, torch, device, q5_n,
              POD_SESSION_RECORDS if not small else 100_000,
              a.pop("q5_rows"))
    c = timed("c", pod_row8, torch, device,
              ROW8_RECORDS if not small else 1 << 15)
    d = timed("d", pod_host_loss, torch, device,
              POD_LOSS_RECORDS if not small else 1 << 17)
    e = timed("e", pod_rank, torch, device)
    launches = {k: a["launches"][k] + b["launches"][k] + d["launches"][k]
                for k in a["launches"]}
    seconds = time.perf_counter() - t_phase
    out = {"a": a, "b": b, "c": c, "d": d, "e": e, "part_seconds": parts}
    print(f"phase 27: {seconds:.1f} s (parts {parts}); launches "
          f"{launches}")
    print("pod " + json.dumps(out, default=str))
    return {**out, "launches": launches, "seconds": seconds}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--records", type=int, default=40_000_000,
                    help="Q5 records (40M: the size of bench.py's run)")
    ap.add_argument("--revenue-records", type=int, default=10_000_000,
                    help="Q5-revenue records")
    ap.add_argument("--session-records", type=int, default=4_000_000,
                    help="BASELINE row 5 session records (4M, cut from "
                    "its 12M to keep the script's time; the paged tier "
                    "evicts from ~1M on)")
    ap.add_argument("--join-records", type=int, default=2_000_000,
                    help="records of each join shape of phase 15 (2M, "
                    "cut from tools/bench_joins.py's 4M to keep the "
                    "script's time)")
    ap.add_argument("--q7-records", type=int, default=10_000_000,
                    help="Q7 bids (10M: BASELINE row 3's size)")
    ap.add_argument("--cep-records", type=int, default=500_000,
                    help="records of phase 16's CEP row (500k, cut from "
                    "tools/bench_cep.py's 4M to keep the script's time; "
                    "250k no longer evicts)")
    args = ap.parse_args()
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        from flink_tpu_torch.stateplane import cuda_build
    except ImportError as e:
        print(f"chip_smoke: the flink_tpu_torch package is missing ({e}); "
              "run from the repository root", file=sys.stderr)
        return 2
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    print(f"phase 1: built {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "Compiling" in line:
                print(f"  ptxas {src}: {line.strip()}")

    phase_rank_parity(torch)
    timing = phase_rank_timing(torch)
    print("rank " + json.dumps(timing))
    _, fold = phase_exchange_scatter(torch)
    q5 = phase_q5(torch, args.records)
    rev = phase_revenue(torch, args.revenue_records)
    q5_p1 = phase_q5(torch, args.records, parallelism=1)
    rev_p1 = phase_revenue(torch, args.revenue_records, parallelism=1)
    phase_fold_p1(torch)
    phase_spill(torch)
    q5_panes = phase_q5(torch, args.records, parallelism=1, layout="panes")
    rev_panes = phase_revenue_panes(torch, args.revenue_records)
    sessions = phase_sessions(torch, args.session_records)
    mesh_sessions = phase_mesh_sessions(torch)
    checkpoints = phase_checkpoints(torch, args.records, phase5=q5)
    joins = phase_joins(torch, args.join_records, args.q7_records)
    cep = phase_cep(torch, args.cep_records)
    slice11 = phase_slice11(torch)
    shard_loss = phase_shard_loss(torch)
    with tempfile.TemporaryDirectory(dir=".") as keep:
        savepoint = os.path.join(keep, "q5-stop-savepoint")
        process = phase_process(torch, keep_savepoint=savepoint)
        sql = phase_sql(torch)
        slice21 = phase_slice21(torch, savepoint=savepoint)
    stage = phase_stage(torch)
    cluster = phase_cluster(torch)
    serving = phase_serving(torch, mc_reads=cluster["a"].pop("queries"))
    tenancy = phase_tenancy(torch, prior=serving)
    scaleout = phase_scaleout(torch)
    pod = phase_pod(torch)
    runs = (q5, rev, q5_p1, rev_p1, q5_panes, rev_panes, sessions,
            mesh_sessions, checkpoints, joins, cep,
            *slice11.values(), shard_loss, process, sql, slice21, stage,
            cluster, serving, tenancy, scaleout, pod)

    kernels = [{
        "name": "exchange_rank",
        "route": "cuda",
        "source": "flink_tpu_torch/csrc/rank.cu",
        "replaces": "flink_tpu/stateplane/rank.py:75",
        "launches": sum(r["launches"]["exchange_rank"] for r in runs),
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "ordered_fold",
        "route": "cuda",
        "source": "flink_tpu_torch/csrc/ordered_fold.cu",
        "replaces": "flink_tpu/parallel/shuffle.py:396",
        "launches": sum(r["launches"]["ordered_fold"] for r in runs),
        "max_abs_err": fold["max_abs_err"],
        "ms": fold["ms"],
        "plain_ms": fold["plain_ms"],
        "bound_ms": fold["bound_ms"],
        "bound_by": fold["bound_by"],
        "library_ms": None,
    }]
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
