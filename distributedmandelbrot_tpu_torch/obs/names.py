"""Canonical metric names, in one place so layers can never drift apart.

Counters predating the registry grew ad hoc, and two of them collided:
``results_accepted`` counted *submissions the coordinator accepted* in
``worker/worker.py`` but *results ingested* in ``coordinator/distributer
.py`` — the same name for two ends of the same wire, which only worked
because the two processes never shared a ``Counters`` instance.  The
``worker_`` / ``coord_`` prefixes make the owner explicit; the legacy
spellings live on as read-side aliases (:data:`LEGACY_ALIASES`) so the
bench harness, the embedded coordinator's settle loop and third-party
scrapers keep working against either name.
"""

from __future__ import annotations

# -- coordinator: distributer ingest/grant path ---------------------------

COORD_WORKLOADS_GRANTED = "workloads_granted"
COORD_REQUESTS_DENIED = "requests_denied"
COORD_READ_TIMEOUTS = "read_timeouts"
COORD_RESULTS_ACCEPTED = "coord_results_accepted"
COORD_RESULTS_REJECTED = "coord_results_rejected"
COORD_RESULTS_DROPPED = "coord_results_dropped"
COORD_CHUNKS_SAVED = "chunks_saved"
COORD_SAVE_ERRORS = "save_errors"
COORD_PERSIST_US = "persist_us"  # microsecond sum (legacy bench field)
# Malformed/hostile frame dropped the connection (net.protocol validators
# raised ProtocolError, or the purpose byte was unknown).
COORD_FRAMES_REJECTED = "coord_frames_rejected"

# -- coordinator: scheduler lease churn -----------------------------------

COORD_REQUEUES = "coord_requeues"
COORD_LEASES_EXPIRED = "coord_leases_expired"
GAUGE_FRONTIER_DEPTH = "coord_frontier_depth"
GAUGE_OUTSTANDING_LEASES = "coord_outstanding_leases"
GAUGE_COMPLETED_TILES = "coord_completed_tiles"

# -- coordinator latency histograms (seconds) -----------------------------

HIST_GRANT_SECONDS = "coord_grant_seconds"
HIST_ACCEPT_SECONDS = "coord_accept_seconds"
HIST_PERSIST_SECONDS = "coord_persist_seconds"

# -- worker ---------------------------------------------------------------

WORKER_RESULTS_ACCEPTED = "worker_results_accepted"
WORKER_RESULTS_REJECTED = "worker_results_rejected"
WORKER_TILES_COMPUTED = "tiles_computed"
WORKER_LEASE_US = "lease_us"
WORKER_COMPUTE_US = "compute_us"
WORKER_UPLOAD_US = "upload_us"
HIST_WORKER_COMPUTE_SECONDS = "worker_compute_seconds"
HIST_WORKER_UPLOAD_SECONDS = "worker_upload_seconds"

# -- worker: pipelined executor -------------------------------------------

# Per-item stage service time (labels: stage=lease|dispatch|materialize|
# upload) and the end-of-run occupancy/bubble gauges the farm bench
# reads.  Occupancy is busy/wall for the stage thread; bubble is its
# complement — the fraction of the run the stage spent waiting on its
# neighbours (1.0 means the stage never limited throughput).
HIST_PIPELINE_STAGE_SECONDS = "worker_pipeline_stage_seconds"
GAUGE_PIPELINE_STAGE_OCCUPANCY = "worker_pipeline_stage_occupancy"
GAUGE_PIPELINE_WINDOW_FILL = "worker_pipeline_window_fill"
PIPELINE_LEASE_EXCHANGES = "worker_pipeline_lease_exchanges"
PIPELINE_TILES_ABANDONED = "worker_pipeline_tiles_abandoned"

# Stage label values, in pipeline order.
STAGE_LEASE = "lease"
STAGE_DISPATCH = "dispatch"
STAGE_MATERIALIZE = "materialize"
STAGE_UPLOAD = "upload"
PIPELINE_STAGES = (STAGE_LEASE, STAGE_DISPATCH, STAGE_MATERIALIZE,
                   STAGE_UPLOAD)

# Backend-internal phase split (labels: phase=dispatch|materialize) —
# replaces PallasBackend's unsynchronized ``phase_us`` dict, which was
# racy the moment two pipeline threads shared a backend.
HIST_BACKEND_PHASE_SECONDS = "worker_backend_phase_seconds"
PHASE_DISPATCH = "dispatch"
PHASE_MATERIALIZE = "materialize"

# Megakernel fusion route (PallasBackend.dispatch_many): how many fused
# launches ran, how many tiles rode them (tiles/launch = the effective
# fusion width, the dispatch-amortization factor of ROADMAP item 4), and
# how many pixels the bf16 scouting pass predicted escape inside its
# window (advisory census only — counts never cross the precision
# boundary; see ops/mixed_precision.py).
WORKER_KERNEL_FUSED_LAUNCHES = "worker_kernel_fused_launches"
WORKER_KERNEL_FUSED_TILES = "worker_kernel_fused_tiles"
WORKER_KERNEL_BF16_PRUNED = "worker_kernel_bf16_pruned_pixels"

# Demotions along the CUDA backend's chain (label ``route``:
# ``fused_to_per_tile`` when a fused batch falls back to per-tile
# launches, ``per_tile_to_torch`` when a tile the kernel declines runs
# the torch escape loop instead, ``mesh_to_fused`` when a batch the mesh
# route declines takes the one-device fused launch, ``batch_to_torch``
# when the mesh backend's kernels decline a batch).  Port-only: the JAX
# backends record these as flight events alone.
WORKER_KERNEL_DEMOTIONS = "worker_kernel_demotions"
ROUTE_FUSED_TO_PER_TILE = "fused_to_per_tile"
ROUTE_PER_TILE_TO_TORCH = "per_tile_to_torch"
ROUTE_MESH_TO_FUSED = "mesh_to_fused"
ROUTE_BATCH_TO_TORCH = "batch_to_torch"

# Mesh megakernel route (one fused launch shard_map'd over every local
# device): launches that took the route, and device-launch equivalents
# (devices per launch summed, so devices/launches = the mesh width the
# route actually spanned; 1-device rings never touch these — the route
# degenerates to the single-device fused launch).
WORKER_MESH_LAUNCHES = "worker_mesh_launches"
WORKER_MESH_DEVICES = "worker_mesh_devices"

# MXU iteration-map gate (ops/mxu_iteration): fused launches that ran
# the matmul-form recurrence (full mode — bit-parity proven on this
# platform), launches demoted to the advisory census because the gate
# was enabled but parity unproven, and the panel pixels that census
# predicted escape for (advisory only, same precision-boundary contract
# as the bf16 scout above).
WORKER_KERNEL_MXU_LAUNCHES = "worker_kernel_mxu_launches"
WORKER_KERNEL_MXU_DEMOTIONS = "worker_kernel_mxu_demotions"
WORKER_KERNEL_MXU_CENSUS = "worker_kernel_mxu_census_pixels"
# Census shadows that raised.  Port-only: the JAX backend logs them at
# debug level alone.  The shadow stays advisory, so a failure never fails
# the batch it shadows; it is counted so that a run can assert none.
WORKER_MXU_CENSUS_FAILURES = "worker_mxu_census_failures"

# -- distributed tracing (cross-process spans) ----------------------------

# Worker-side span push over PURPOSE_SPANS (0x04): records pushed,
# reports sent, and the one-shot degradation counter bumped when a
# legacy coordinator closes the connection on the unknown purpose byte.
WORKER_SPANS_PUSHED = "worker_spans_pushed"
WORKER_SPAN_REPORTS = "worker_span_reports"
WORKER_SPANS_UNSUPPORTED = "worker_spans_unsupported"
WORKER_SPANS_DROPPED = "worker_spans_dropped"
# Coordinator-side ingest.
COORD_SPAN_REPORTS = "coord_span_reports"
COORD_SPANS_INGESTED = "coord_spans_ingested"
COORD_SPAN_SYNC_SAMPLES = "coord_span_sync_samples"
COORD_SPANS_UNALIGNED = "coord_spans_unaligned"

# Span stage label values, in worker pipeline order.  ``prefetch`` is
# the lease exchange that delivered the tile, ``dispatch`` the host-side
# kernel enqueue, ``compute`` the tile's device residency (dispatch
# start -> materialized), ``d2h`` the device wait + device->host copy,
# ``upload`` the submit exchange.  The wire carries these as one-byte
# codes (net/protocol.py SPAN_STAGE_*).
SPAN_PREFETCH = "prefetch"
SPAN_DISPATCH = "dispatch"
SPAN_COMPUTE = "compute"
SPAN_D2H = "d2h"
SPAN_UPLOAD = "upload"
SPAN_STAGES = (SPAN_PREFETCH, SPAN_DISPATCH, SPAN_COMPUTE, SPAN_D2H,
               SPAN_UPLOAD)

# -- persistent session wire (PURPOSE_SESSION, 0x05) -----------------------

# Coordinator side: connections accepted (the session e2e asserts a
# steady-state farm run stays at one per worker lane), sessions
# upgraded, frames carried, and the off-loop RLE decode latency.
COORD_CONNECTIONS_ACCEPTED = "coord_connections_accepted"
COORD_SESSIONS_OPENED = "coord_sessions_opened"
COORD_SESSION_FRAMES = "coord_session_frames"
HIST_COORD_DECODE_SECONDS = "coord_decode_seconds"
# Wire volume split by codec tier, counted identically on both ends
# (coordinator: bodies ingested; worker: bodies sent) — the farm bench
# reads the worker's to report the compression win.
WIRE_RAW_BYTES = "wire_raw_bytes"
WIRE_COMPRESSED_BYTES = "wire_compressed_bytes"
# Worker side: sessions opened, fallbacks onto the legacy
# connection-per-exchange path (legacy coordinator or mid-run session
# loss), re-dials after the coordinator's idle deadline dropped a quiet
# lane (expected under slow backends — tiles can out-wait the read
# timeout between batches), blocking round trips paid (lease exchanges
# + pipelined-ack waits — the bench divides by tiles for
# farm_rtts_per_tile), and the per-lane busy-time histogram behind the
# bench's lane occupancy.
WORKER_SESSIONS_OPENED = "worker_sessions_opened"
WORKER_SESSION_FALLBACKS = "worker_session_fallbacks"
WORKER_SESSION_REDIALS = "worker_session_redials"
WORKER_WIRE_RTTS = "worker_wire_rtts"
HIST_UPLOAD_LANE_BUSY_SECONDS = "worker_upload_lane_busy_seconds"

# Batched lease grants (SESSION_FLAG_GRANTN): GRANTN exchanges served
# and the tiles-per-exchange distribution (the grant-coalescing factor
# the farm bench divides into round trips), plus the depth of the
# accept-path's bounded persist queue (a standing backlog here means
# group commits, not the event loop, are the bottleneck).
COORD_GRANT_BATCHES = "coord_grant_batches"
HIST_COORD_GRANTS_PER_BATCH = "coord_grants_per_batch"
GAUGE_PERSIST_QUEUE_DEPTH = "coord_persist_queue_depth"

# -- sharded control plane (control/ring + shard session frames) ----------

# Coordinator side: ring-info exchanges served (FRAME_RING_REQ), ring
# version skew observed (client offered a different ring version than
# the shard is running — expected transiently during a ring rollout),
# uploads that arrived at the wrong shard (misroutes), and the subset of
# those answered with a FRAME_REDIRECT carrying the authoritative shard
# (SHARD-negotiated sessions; legacy sessions get a plain REJECT ack).
COORD_SHARD_RING_REQS = "coord_shard_ring_reqs"
COORD_SHARD_RING_SKEW = "coord_shard_ring_skew"
COORD_SHARD_MISROUTES = "coord_shard_misroutes"
COORD_SHARD_REDIRECTS = "coord_shard_redirects"
# Worker side: redirects followed (result re-submitted to the
# authoritative shard) and submissions abandoned because the redirect
# chain exceeded MAX_REDIRECT_HOPS (a ring split-brain signature).
WORKER_REDIRECTS = "worker_redirects"
WORKER_REDIRECT_LOOPS = "worker_redirect_loops"
# Gateway side: read queries for keys this shard does not own, answered
# with QUERY_REDIRECT + the authoritative shard.  The dataserver answers
# misrouted raw chunk queries the same way, under its own counter.
GATEWAY_REDIRECTS = "gateway_redirects"
DATASERVER_REDIRECTS = "dataserver_redirects"

# -- chaos suite (control-plane fault schedules) ---------------------------

# Scenario runner accounting: processes killed on schedule, processes
# restarted, grants observed across restarts, and invariant violations
# (exactly-once/golden-parity/grant-fencing breaks — must stay 0).
CHAOS_KILLS = "chaos_kills"
CHAOS_RESTARTS = "chaos_restarts"
CHAOS_INVARIANT_FAILURES = "chaos_invariant_failures"

# -- store ----------------------------------------------------------------

HIST_STORE_READ_SECONDS = "store_read_seconds"
HIST_STORE_WRITE_SECONDS = "store_write_seconds"
# Startup tail repair: a crash mid-append left a truncated final entry
# and setup cut the index back to the last valid boundary.
STORE_TORN_TAILS_REPAIRED = "store_torn_tails_repaired"
# Group commits (put_many): batches flushed with one index append and
# the tiles those flushes carried (tiles/commit = the flush size the
# scale-out bench reports).
STORE_GROUP_COMMITS = "store_group_commits"
STORE_FLUSH_TILES = "store_flush_tiles"

# -- coordinator: durability (checkpoint/restore) -------------------------

# Periodic + on-demand scheduler checkpoints written (and failures).
COORD_CHECKPOINTS_WRITTEN = "coord_checkpoints_written"
COORD_CHECKPOINT_ERRORS = "coord_checkpoint_errors"
HIST_CHECKPOINT_SECONDS = "coord_checkpoint_seconds"
# Restore path: startups that restored from a checkpoint, index entries
# replayed during restore (suffix-only when a checkpoint was used — the
# kill-and-restart e2e asserts replayed < total), and leases rebuilt so
# in-flight workers can land results across the restart.
COORD_RESTORES = "coord_restores"
COORD_REPLAY_ENTRIES = "coord_replay_entries"
COORD_RESTORED_LEASES = "coord_restored_leases"

# -- worker: reconnect ----------------------------------------------------

# Backoff-then-redial cycles after a dropped coordinator connection
# (capped exponential + jitter; a coordinator restart no longer kills
# the farm run).
WORKER_RECONNECTS = "worker_reconnects"

# -- coordinator: legacy dataserver ---------------------------------------

DATASERVER_QUERIES_SERVED = "queries_served"
DATASERVER_QUERIES_REJECTED = "queries_rejected"
DATASERVER_QUERIES_UNAVAILABLE = "queries_unavailable"

# -- serving gateway + caches ---------------------------------------------

GATEWAY_QUERIES = "gateway_queries"
GATEWAY_SERVED = "gateway_served"
GATEWAY_REJECTED = "gateway_rejected"
GATEWAY_OVERLOADED = "gateway_overloaded"
GATEWAY_UNAVAILABLE = "gateway_unavailable"
GATEWAY_BATCHES = "gateway_batches"
# Malformed/hostile frame dropped the connection (batch count outside
# the validator's bounds, garbage framing).
GATEWAY_FRAMES_REJECTED = "gateway_frames_rejected"
HIST_GATEWAY_REQUEST_SECONDS = "gateway_request_seconds"
TILE_CACHE_HITS = "tile_cache_hits"
TILE_CACHE_MISSES = "tile_cache_misses"
TILE_CACHE_EVICTIONS = "tile_cache_evictions"
TILE_CACHE_PROMOTIONS = "tile_cache_promotions"
TILE_CACHE_STORE_MISSES = "tile_cache_store_misses"
GAUGE_TIER1_HIT_RATIO = "tile_cache_tier1_hit_ratio"
GAUGE_TIER2_HIT_RATIO = "tile_cache_tier2_hit_ratio"

# Rendered-tile tier (GATEWAY_RENDER_MAGIC framing): query/serve volume,
# the palette-PNG render cache's movement counters and live hit ratio,
# the render latency histogram, and the named reject counter the fuzz
# suite pins for unknown colormap ids.
GATEWAY_RENDER_QUERIES = "gateway_render_queries"
GATEWAY_RENDER_SERVED = "gateway_render_served"
GATEWAY_RENDER_CACHE_HITS = "gateway_render_cache_hits"
GATEWAY_RENDER_CACHE_MISSES = "gateway_render_cache_misses"
GATEWAY_RENDER_CACHE_EVICTIONS = "gateway_render_cache_evictions"
GATEWAY_RENDER_UNKNOWN_COLORMAP = "gateway_render_unknown_colormap"
GAUGE_RENDER_HIT_RATIO = "gateway_render_hit_ratio"
HIST_GATEWAY_RENDER_SECONDS = "gateway_render_seconds"

# Interactive sessions (GATEWAY_SESSION_MAGIC framing): session
# lifecycle (opens, queries, table expiry/eviction, the live-session
# gauge), the named reject counters the fuzz suite pins (unknown session
# id — soft reject; unknown flag bits — dropped connection; session
# framing hitting a gateway without the subsystem), and per-session fair
# admission (budget-exhausted sheds, counted apart from the global
# GATEWAY_OVERLOADED so a starved flash crowd is tellable from a dry
# global bucket).
SESSION_OPENS = "session_opens"
SESSION_QUERIES = "session_queries"
SESSION_UNKNOWN = "session_unknown"
SESSION_BAD_FLAGS = "session_bad_flags"
SESSION_UNSUPPORTED = "session_unsupported"
SESSION_THROTTLED = "session_throttled"
SESSION_EXPIRED = "session_expired"
SESSION_EVICTED = "session_evicted"
GAUGE_SESSIONS_ACTIVE = "session_active"
HIST_SESSION_REQUEST_SECONDS = "session_request_seconds"

# Predictive prefetch along the session trajectory: tiles the planner
# picked (in-range, not already cached, not already marked), tiles warmed
# into tier 1 from the store, tiles handed to scheduler.prioritize for
# compute-on-read, and the hit/miss split — a hit is a session query
# landing on a tile the planner marked for it, the ratio gauge is the
# live quality signal for the predictor.
PREFETCH_PLANNED = "prefetch_planned"
PREFETCH_WARMED = "prefetch_warmed"
PREFETCH_SCHEDULED = "prefetch_scheduled"
PREFETCH_HITS = "prefetch_hits"
PREFETCH_MISSES = "prefetch_misses"
GAUGE_PREFETCH_HIT_RATIO = "prefetch_hit_ratio"

# Progressive refinement: first paints served from the cheap low-iter
# variant, full-depth workloads handed back to the scheduler, and deep
# variants persisted (which invalidate the stale cache tiers below).
SESSION_FIRST_PAINTS = "session_first_paints"
SESSION_REFINES_SCHEDULED = "session_refines_scheduled"
SESSION_REFINES_COMPLETED = "session_refines_completed"

# Cache-tier invalidation when a deeper-max_iter variant of a cached
# tile persists (the store's payload LRU self-heals on save; the decoded
# and rendered tiers are dropped explicitly so the next read re-reads
# the deep variant).
TILE_CACHE_INVALIDATIONS = "tile_cache_invalidations"
GATEWAY_RENDER_CACHE_INVALIDATIONS = "gateway_render_cache_invalidations"

# Serve-side RLE recompression of cold raw payloads (legacy raw-only data
# dirs): payloads re-encoded on promotion, payloads left raw (estimate
# said RLE cannot win), and wire bytes saved by the re-encode.
SERVE_RLE_RECOMPRESSIONS = "serve_rle_recompressions"
SERVE_RLE_SKIPPED = "serve_rle_skipped"
SERVE_RLE_BYTES_SAVED = "serve_rle_bytes_saved"

COALESCE_LEADERS = "coalesce_leaders"
COALESCE_FOLLOWERS = "coalesce_followers"
ONDEMAND_REQUESTS = "ondemand_requests"
ONDEMAND_TIMEOUTS = "ondemand_timeouts"
ONDEMAND_SERVED = "ondemand_served"
# A tile the scheduler believed completed missed the store for a full
# poll window: the bytes are gone (wiped data dir, foreign store), so
# on-demand un-completed it via ``refine`` and re-granted the compute.
ONDEMAND_HEALED = "ondemand_healed"

# Gateway per-request outcome label values (one histogram, split by how
# the request resolved).
OUTCOME_TIER1 = "tier1_hit"
OUTCOME_STORE = "store_hit"
OUTCOME_COMPUTED = "computed"
OUTCOME_UNAVAILABLE = "unavailable"
OUTCOME_REJECTED = "rejected"
OUTCOME_OVERLOADED = "overloaded"
# Rendered-tile outcomes: served straight from the render cache, or
# rendered on this request (pixels from tier-1/store/compute).
OUTCOME_RENDER_CACHE = "render_hit"
OUTCOME_RENDERED = "rendered"
# Sharded serving: the key belongs to another shard; the client was
# pointed at the authoritative one.
OUTCOME_REDIRECTED = "redirected"
# Interactive sessions: served the cheap low-iter first paint (full
# depth refines in the background), or shed by the session's own
# admission budget rather than the global bucket.
OUTCOME_FIRST_PAINT = "first_paint"
OUTCOME_SESSION_THROTTLED = "session_throttled"

# -- loadgen (open-loop storm harness) --------------------------------------

# Per-phase request accounting (labels: phase=<phase name>): requests
# issued on the open-loop schedule, completions by class (OK payloads,
# OVERLOADED sheds, NOT_AVAILABLE misses, transport/protocol errors),
# and issues dropped because the client itself ran out of in-flight
# budget (counted separately — client saturation must never masquerade
# as server goodput).
LOADGEN_REQUESTS = "loadgen_requests"
LOADGEN_COMPLETED = "loadgen_completed"
LOADGEN_SHED = "loadgen_shed"
LOADGEN_UNAVAILABLE = "loadgen_unavailable"
LOADGEN_ERRORS = "loadgen_errors"
LOADGEN_CLIENT_SATURATED = "loadgen_client_saturated"
LOADGEN_BYTES = "loadgen_bytes"
HIST_LOADGEN_LATENCY_SECONDS = "loadgen_latency_seconds"

# -- fleet observability plane (obs/timeseries + obs/fleet + obs/slo) ------

# Ring-buffer sampler: snapshots taken, per-snapshot cost, and the live
# count of distinct series the history currently carries.
TS_SAMPLES = "ts_samples"
HIST_TS_SAMPLE_SECONDS = "ts_sample_seconds"
GAUGE_TS_SERIES = "ts_series"

# Fleet aggregator: scrape rounds completed, per-peer fetch failures
# (malformed/truncated/oversized bodies, unreachable peers — the peer is
# marked stale, never crashed on), per-fetch latency, and the live
# peer/stale/straggler population gauges the dashboard header reads.
FLEET_SCRAPES = "fleet_scrapes"
FLEET_SCRAPE_ERRORS = "fleet_scrape_errors"
HIST_FLEET_SCRAPE_SECONDS = "fleet_scrape_seconds"
GAUGE_FLEET_PEERS = "fleet_peers"
GAUGE_FLEET_PEERS_STALE = "fleet_peers_stale"
GAUGE_FLEET_STRAGGLERS = "fleet_stragglers"

# SLO layer: live burn-rate gauges (labels: slo=<name>,
# window=fast|slow) and the alert-transition counters (labels:
# slo=<name>) bumped by the state machine in obs/slo.py.
GAUGE_SLO_BURN = "slo_burn_rate"
SLO_ALERTS_FIRED = "slo_alerts_fired"
SLO_ALERTS_RECOVERED = "slo_alerts_recovered"

# -- flight recorder + postmortem (obs/flight + obs/postmortem) ------------

# Black-box ring totals (live gauges read off the recorder — the hot
# note() path never touches the registry), dump files written across
# the exit paths, and the postmortem assembler's load accounting:
# dumps merged, corrupt/truncated lines tolerated-but-counted, and
# anomalies (grant-without-accept, ping-pong, redirect loops, retry
# storms, double-commit evidence) the detectors surfaced.
GAUGE_FLIGHT_EVENTS = "flight_events"
GAUGE_FLIGHT_EVENTS_DROPPED = "flight_events_dropped"
FLIGHT_DUMPS = "flight_dumps"
POSTMORTEM_DUMPS_LOADED = "postmortem_dumps_loaded"
POSTMORTEM_DUMP_ERRORS = "postmortem_dump_errors"
POSTMORTEM_ANOMALIES = "postmortem_anomalies"

# -- a render's phases (obs/phases.py) --------------------------------------

# Port-only.  Host-clock seconds and entries by phase of one ``render``:
# its argument parse, the colormap, the float-to-uint8 step, deflate and
# the file write; the deep route's reference search, BLA
# probe and tables, scans, secondary and exact repairs, the fixed-point
# orbits it computes and its probe scans; and the route's counts of
# glitched and exactly repaired pixels, of the steps K10's lanes needed,
# and of the views that took BLA; and the bands a PNG's deflate took.  A
# phase that launches no device work also appears in a ``torch.profiler``
# trace as an annotation named with the prefix before its key.
PHASE_ANNOTATION_PREFIX = "dmtpu."
PHASE_RENDER_PARSE = "render.parse"
PHASE_RENDER_COLORMAP = "render.colormap"
PHASE_RENDER_RGBA8 = "render.rgba8"
PHASE_RENDER_DEFLATE = "render.deflate"
PHASE_RENDER_WRITE = "render.write"
PHASE_DEEP_REFERENCE = "reference"
PHASE_DEEP_BLA_PROBE = "bla_probe"
PHASE_DEEP_BLA_TABLE = "bla_table"
PHASE_DEEP_SCAN = "scan"
PHASE_DEEP_REPAIR_SECONDARY = "repair_secondary"
PHASE_DEEP_REPAIR_EXACT = "repair_exact"
PHASE_DEEP_ORBIT = "deep.orbit"
PHASE_DEEP_PROBE = "deep.probe"
COUNT_DEEP_GLITCHED = "glitched"
COUNT_DEEP_EXACT_REPAIRED = "exact_repaired"
COUNT_DEEP_LANE_STEPS = "deep.lane_steps"
COUNT_DEEP_BLA_VIEWS = "deep.bla_views"
COUNT_DEEP_K10_TILES = "deep.k10_tiles"
COUNT_RENDER_DEFLATE_BANDS = "render.deflate_bands"

# -- legacy aliases -------------------------------------------------------

# canonical name -> the spelling pre-registry call sites read.  Reads of a
# legacy name sum every canonical counter aliased to it, reproducing the
# old shared-Counters semantics (a process that both granted and computed
# saw one merged ``results_accepted``).
LEGACY_ALIASES: dict[str, str] = {
    COORD_RESULTS_ACCEPTED: "results_accepted",
    WORKER_RESULTS_ACCEPTED: "results_accepted",
    COORD_RESULTS_REJECTED: "results_rejected",
    WORKER_RESULTS_REJECTED: "results_rejected",
    COORD_RESULTS_DROPPED: "results_dropped",
}
