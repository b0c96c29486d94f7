"""`perf explain <doc>`: the per-doc causal convergence debugger.

`perf doctor` answers "which NODE is unhealthy and why"; this module
answers the doc-granular question underneath it — "why isn't doc X
converged on node Y, and where exactly are its changes stuck?" — by
walking the convergence ledger (sync/docledger.py) of every visible
node and joining the lanes: node Y's frontier for doc X lags peer W's
advertised clock by k changes; on W's side the same doc's lane shows
whether those changes were dropped before the wire, framed but not yet
integrated, parked in an epoch buffer, or never framed at all.

Blocking-cause classes (stable identifiers — bench config 12 asserts on
them, most-specific first):

    doc_frame_loss          the AHEAD peer is dropping its change-bearing
                            sends of this doc (chaos doc-stall, transport
                            failures) — its ledger lane counts the drops
    doc_epoch_buffered      the lagging node has entries for the doc
                            parked in its epoch ingest buffer (flusher
                            wedged or overwhelmed)
    doc_causal_queue        the lagging node RECEIVED more useful changes
                            than it admitted — they are parked in causal
                            order, a dependency has not arrived
    doc_unacked_in_flight   the ahead peer framed the changes (sent > 0,
                            recently) but the lagging node has not
                            integrated them — wire or apply path latency
    doc_connection_stalled  the lagging node still hears clock adverts
                            from the ahead peer but change-bearing
                            messages stopped arriving
    doc_unsubscribed        the lagging node EXPLICITLY unsubscribed the
                            doc from the ahead peer (sync/connection.py
                            subscribe(remove=...)) — the lag is chosen,
                            not a fault; heavy sub_events churn on the
                            lane is called out (the sub_flap chaos
                            class). Unsubscribed lag is EXPLAINED here
                            but never FLAGGED in the hot list.
    doc_not_replicated      the ahead peer never framed the doc's changes
                            for this lane at all (no interest, or a
                            wedged gossip handler)

Views come from three places, mirroring the doctor's modes:

- **local** (`gather_local()`): every live ledger in this process —
  the in-process mesh posture (bench config 12, tests);
- **live** (`--connect host:port,...`): `{"metrics": "pull"}` answers,
  whose nested `"docledger"` sections carry each node's ledger;
- **post-mortem** (`--post-mortem PATH`): a flight-recorder dump, raw
  snapshot, or BENCH_DETAIL.json — the same sections, read cold. The
  "now" used for live lag ages is the newest stamp in the capture, so
  a post-mortem reads the ages as of the incident, not the autopsy.

CLI: `python -m automerge_tpu_torch.perf explain [DOC] [--connect ...|
--post-mortem PATH] [--json]`. Without DOC it prints the hot list —
the worst-lagging docs across every visible node — which is also what
`perf doctor` joins into its ranked report and `perf top` renders as
the per-doc panel.
"""

from __future__ import annotations

import json
import os
import sys
import time

from . import history

#: a lane is "recent" within this many seconds of the reference clock —
#: separates in-flight changes from a stalled connection
RECENT_S = 5.0


# ---------------------------------------------------------------------------
# view gathering


def views_from_snapshot(snapshot: dict) -> dict:
    """{label: per-node ledger section} out of one metrics snapshot.
    Labels are kept VERBATIM — they are what `behind_peer` fields
    reference, so any decoration would break the sender-side join."""
    sec = (snapshot or {}).get("docledger") or {}
    nodes = sec.get("nodes") or {}
    return {label: view for label, view in nodes.items()
            if isinstance(view, dict)}


def merge_views(parts: list[dict]) -> dict:
    """Merge view dicts, disambiguating label collisions positionally."""
    out: dict = {}
    for part in parts:
        for label, view in part.items():
            k, i = label, 1
            while k in out:
                i += 1
                k = f"{label}#{i}"
            out[k] = view
    return out


def gather_local(k: int | None = None) -> dict:
    """Views from every live ledger in THIS process (the in-process mesh
    posture). Refreshes each ledger's tracked clocks first — explain is
    a diagnostic caller that owns its context, so the locked read is
    allowed here (unlike in snapshot providers). `k` overrides each
    ledger's export cap (the `--k` flag; default: the ledger's own
    export_k, which honors AMTPU_DOCLEDGER_K)."""
    from ..sync import docledger

    parts = []
    for led in docledger.ledgers():
        try:
            led.refresh_clocks()
        except Exception:
            pass
        sec = led.section(k=k)
        if sec:
            parts.append({sec["label"]: sec})
    return merge_views(parts)


def views_asof(views: dict) -> float:
    """Reference clock for lag ages: the newest stamp anywhere in the
    views (a post-mortem must read ages as of the incident). Falls back
    to time.time() for empty views."""
    newest = 0.0
    for view in views.values():
        for e in (view.get("docs") or {}).values():
            for stamp in (e.get("last_admit_at"), e.get("behind_since")):
                if isinstance(stamp, (int, float)):
                    newest = max(newest, stamp)
            for pv in (e.get("peers") or {}).values():
                for k in ("last_advert_at", "last_send_at",
                          "last_recv_at"):
                    s = pv.get(k)
                    if isinstance(s, (int, float)):
                        newest = max(newest, s)
    return newest or time.time()


# ---------------------------------------------------------------------------
# the causal walk

# one cause/merge policy across the whole diagnostic plane: the doctor
# owns it, explain reuses it (same dict shape, same max-score merge)
from .doctor import _cause, _ranked  # noqa: E402


def explain_doc(doc_id: str, views: dict, now: float | None = None) -> dict:
    """Ranked blocking-cause report for one doc across every view.
    `views` is {node_label: ledger section} (views_from_snapshot /
    gather_local); `now` defaults to views_asof — pass time.time() only
    for live fleets."""
    now = views_asof(views) if now is None else now
    causes: list = []
    frontiers: dict = {}
    seen_anywhere = False
    for label, view in sorted(views.items()):
        e = (view.get("docs") or {}).get(doc_id)
        if e is None:
            continue
        seen_anywhere = True
        deficit = int(e.get("lag_changes") or 0)
        behind_since = e.get("behind_since")
        lag_live = (round(max(0.0, now - behind_since), 3)
                    if isinstance(behind_since, (int, float)) else
                    float(e.get("lag_s") or 0.0))
        buffered = int(e.get("buffered") or 0)
        frontiers[label] = {
            "admitted": e.get("admitted"),
            "buffered": buffered,
            "lag_changes": deficit,
            "lag_s": lag_live,
            "behind_peer": e.get("behind_peer"),
        }
        if buffered:
            _cause(causes, "doc_epoch_buffered", label,
                   5.0 + buffered, [
                       f"{label}: {buffered} ingress entr"
                       f"{'y' if buffered == 1 else 'ies'} for {doc_id!r} "
                       "parked in the epoch buffer (flusher wedged or "
                       "overwhelmed)"])
        if deficit <= 0:
            continue
        w = e.get("behind_peer")
        head = (f"{label}'s frontier for {doc_id!r} lags peer "
                f"{w or '?'} by {deficit} change(s), behind for "
                f"{lag_live:.3f}s")
        # the lagging node's own receive lane for the ahead peer
        pv = (e.get("peers") or {}).get(w) if w else None
        if pv is not None and pv.get("unsubscribed"):
            # the lag is CHOSEN: this node unsubscribed the doc from the
            # ahead peer, whose adverts keep the deficit honest — rank
            # it as its own cause so nobody chases a phantom stall
            flaps = int(pv.get("sub_events") or 0)
            churn = (f" (interest churn: {flaps} subscribe/unsubscribe "
                     "toggles on the lane — sub_flap chaos or an "
                     "over-eager interest manager)"
                     if flaps >= 3 else "")
            _cause(causes, "doc_unsubscribed", label, 6.0 + deficit, [
                head + f"; {label} explicitly UNSUBSCRIBED {doc_id!r} "
                f"from {w} — frames stopped by choice, adverts keep the "
                "frontier visible; resubscribe to backfill" + churn])
            continue
        recv_total = sum(int(p.get("recv_useful") or 0)
                         for p in (e.get("peers") or {}).values())
        admitted = int(e.get("admitted") or 0)
        queued = max(0, recv_total - admitted)
        if queued:
            _cause(causes, "doc_causal_queue", label,
                   3.0 + queued, [
                       head + f"; it RECEIVED {queued} more useful "
                       "change(s) than it admitted — parked causally, a "
                       "dependency has not arrived"])
        # the ahead peer's send lane toward this node, when its ledger
        # is visible (labels must join: peer_label/AMTPU_NODE_NAME)
        sender = views.get(w) if w else None
        se = ((sender or {}).get("docs") or {}).get(doc_id)
        spv = ((se or {}).get("peers") or {}).get(label)
        if spv is not None:
            drops = int(spv.get("drops") or 0)
            sent = int(spv.get("sent") or 0)
            last_send = spv.get("last_send_at")
            if drops:
                _cause(causes, "doc_frame_loss", w, 10.0 + drops, [
                    head + f"; {w} DROPPED {drops} change-bearing "
                    f"send(s) of {doc_id!r} toward {label} before the "
                    "wire (chaos doc-stall or transport failure)"])
                continue
            if sent and isinstance(last_send, (int, float)) \
                    and now - last_send <= RECENT_S:
                _cause(causes, "doc_unacked_in_flight", w,
                       1.0 + deficit, [
                           head + f"; {w} framed {sent} change(s) "
                           f"({now - last_send:.3f}s ago) that "
                           f"{label} has not integrated — wire or "
                           "apply-path latency"])
                continue
            if not sent:
                _cause(causes, "doc_not_replicated", w,
                       2.0 + deficit, [
                           head + f"; {w} NEVER framed the doc's "
                           f"changes for {label} (no interest, or a "
                           "wedged gossip handler)"])
                continue
        # sender side invisible or inconclusive: judge from the
        # receiver's lane ages
        if pv is not None:
            last_recv = pv.get("last_recv_at")
            last_advert = pv.get("last_advert_at")
            advert_age = (now - last_advert
                          if isinstance(last_advert, (int, float))
                          else None)
            recv_age = (now - last_recv
                        if isinstance(last_recv, (int, float)) else None)
            if advert_age is not None and advert_age <= RECENT_S and (
                    recv_age is None or recv_age > RECENT_S):
                _cause(causes, "doc_connection_stalled", label,
                       2.0 + deficit, [
                           head + f"; {w} still adverts its clock "
                           f"({advert_age:.3f}s ago) but change-"
                           "bearing messages stopped arriving" +
                           (f" (last {recv_age:.3f}s ago)"
                            if recv_age is not None else
                            " (none ever arrived)")])
                continue
        _cause(causes, "doc_unacked_in_flight", label, deficit, [
            head + "; sender-side ledger not visible — label the "
            "connections (peer_label / AMTPU_NODE_NAME) for exact "
            "attribution"])
    # merge same-(cause, node) rows (two lagging receivers both blaming
    # one sender is ONE cause) and rank most-severe first — the
    # doctor's shared policy
    causes = _ranked(causes)
    converged = seen_anywhere and all(
        f["lag_changes"] == 0 for f in frontiers.values())
    return {"mode": "explain", "doc": doc_id,
            "tracked_on": sorted(frontiers),
            "seen": seen_anywhere,
            "converged": bool(converged and not causes),
            "frontiers": frontiers,
            "causes": causes}


def hot_docs(views: dict, limit: int = 8,
             now: float | None = None,
             tenant: str | None = None) -> list[dict]:
    """The worst-lagging (doc, node) rows across every view — the
    no-argument CLI listing, the doctor's per-doc join, and perf top's
    panel feed. Converged docs are excluded; `tenant` restricts the list
    to docs resolving to that tenant id (the `--tenant` CLI filter,
    sync/tenantledger.py derivation)."""
    now = views_asof(views) if now is None else now
    rows = []
    for label, view in views.items():
        for d, e in (view.get("docs") or {}).items():
            if tenant is not None:
                from ..sync.tenantledger import tenant_of
                if tenant_of(d) != tenant:
                    continue
            deficit = int(e.get("lag_changes") or 0)
            buffered = int(e.get("buffered") or 0)
            if deficit <= 0 and not buffered:
                continue
            bp = (e.get("peers") or {}).get(e.get("behind_peer") or "")
            if deficit > 0 and not buffered and bp \
                    and bp.get("unsubscribed"):
                # chosen lag (the node unsubscribed this doc): explained
                # by `perf explain <doc>` (doc_unsubscribed), never
                # flagged in the hot list — a deliberate opt-out must
                # not page anyone
                continue
            bs = e.get("behind_since")
            rows.append({
                "doc": d, "node": label,
                "lag_changes": deficit,
                "lag_s": (round(max(0.0, now - bs), 3)
                          if isinstance(bs, (int, float)) else
                          float(e.get("lag_s") or 0.0)),
                "buffered": buffered,
                "behind_peer": e.get("behind_peer"),
            })
    rows.sort(key=lambda r: (-r["lag_changes"], -r["lag_s"]))
    return rows[:limit]


# ---------------------------------------------------------------------------
# rendering + CLI


def report_lines(report: dict) -> list[str]:
    # resolved tenant in the header (sync/tenantledger.py prefix rule):
    # pure derivation from the doc id, so it names the account even for
    # docs no ledger has seen
    from ..sync import tenantledger
    tenant = (f" [tenant {tenantledger.tenant_of(report['doc'])}]"
              if tenantledger.enabled() else "")
    lines = [f"# perf explain — doc {report['doc']!r}{tenant}"]
    if not report["seen"]:
        lines.append("  doc not present in any visible ledger (idle, "
                     "evicted to the aggregate bucket, or the node "
                     "exports a smaller hot set)")
        return lines
    for label in sorted(report["frontiers"]):
        f = report["frontiers"][label]
        state = ("converged" if f["lag_changes"] == 0 and not f["buffered"]
                 else f"lags {f['behind_peer']} by {f['lag_changes']} "
                      f"change(s) / {f['lag_s']:.3f}s"
                      + (f", {f['buffered']} buffered"
                         if f["buffered"] else ""))
        lines.append(f"  {label}: admitted {f['admitted']}, {state}")
    causes = report.get("causes") or []
    if report.get("converged"):
        lines.append("  verdict: CONVERGED on every visible node")
    elif not causes:
        lines.append("  no blocking cause above threshold (lag may be "
                     "transient, or ledgers are not labeled for joins)")
    for i, c in enumerate(causes, 1):
        where = f" @ {c['node']}" if c.get("node") else ""
        lines.append(f"  {i}. {c['cause']}{where} (score {c['score']})")
        for ev in c.get("evidence") or []:
            lines.append(f"       - {ev}")
    return lines


def hot_lines(views: dict, limit: int = 8,
              tenant: str | None = None) -> list[str]:
    rows = hot_docs(views, limit=limit, tenant=tenant)
    scope = f" [tenant {tenant}]" if tenant is not None else ""
    if not rows:
        return ["# perf explain — no lagging docs in any visible "
                f"ledger{scope}"]
    lines = ["# perf explain — hot docs (worst converge lag first)"
             + scope]
    for r in rows:
        lines.append(
            f"  {r['doc']!r} @ {r['node']}: {r['lag_changes']} change(s)"
            f" / {r['lag_s']:.3f}s behind {r['behind_peer'] or '?'}"
            + (f", {r['buffered']} buffered" if r["buffered"] else ""))
    lines.append("  (run `perf explain <doc>` for the causal walk)")
    return lines


def trace_stage_lines(doc_id: str, tsections: dict,
                      limit: int = 2) -> list[str]:
    """The stage-breakdown band for one doc: completed trace-plane
    exemplars (utils/tracer.py ring) whose lifecycle ran through
    `doc_id`, each decomposed into its stage durations with the share
    of that trace's end-to-end critical path. `tsections` is
    {node_label: traceplane section}. Empty when no section carries a
    matching exemplar — the band simply disappears (same contract as
    the hot-doc / dispatch / tenant panels)."""
    rows = []
    for label, sec in (tsections or {}).items():
        for t in (sec or {}).get("exemplars") or []:
            if t.get("doc") == doc_id and t.get("spans"):
                rows.append((label, t))
    if not rows:
        return []
    rows.sort(key=lambda r: -(r[1].get("crit_s") or 0.0))
    lines = ["  stage breakdown (sampled traces; `perf trace`):"]
    for label, t in rows[:limit]:
        crit = max(float(t.get("crit_s") or 0.0), 1e-9)
        role = "stitched across the wire" if t.get("stitched") \
            else "origin-local"
        lines.append(f"    trace {t.get('tid')} @ {label} "
                     f"({role}, e2e {crit:.4f}s):")
        for st, _rel, dur in t["spans"]:
            share = 100.0 * float(dur) / crit
            lines.append(f"      {st:<17} {float(dur):>10.6f}s "
                         f"{share:>5.1f}%")
        meta = t.get("meta") or {}
        if meta.get("mega_docs") is not None:
            waste = meta.get("mega_pad_waste_pct")
            lines.append(
                f"      (ops rode fused round {meta.get('round', '?')}: "
                f"{meta.get('mega_docs')} doc(s) across "
                f"{meta.get('mega_buckets')} bucket(s)"
                + (f", {waste:.1f}% pad waste" if waste is not None else "")
                + ")")
    if len(rows) > limit:
        lines.append(f"    (+{len(rows) - limit} more sampled trace(s) "
                     "— run `perf trace` for the waterfalls)")
    return lines


def _post_mortem_view_sets(path: str) -> list[tuple[str, dict]]:
    """(label, views) sets from a post-mortem file. A BENCH_DETAIL.json
    yields ONE SET PER CONFIG — never merged: the node labels inside a
    config's capture must stay exactly the labels its `behind_peer`
    fields reference, or the sender-side join (the whole point of the
    causal walk) silently fails on a prefix mismatch."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(f"{path}: not a JSON object")
    from .traceplane import sections_from_snapshot as _tsecs
    if "configs" in data and "reason" not in data:
        out = []
        for cfg in sorted(data["configs"] or {}, key=lambda c: (len(c), c)):
            snap = ((data["configs"][cfg] or {}).get("metrics")
                    if isinstance(data["configs"][cfg], dict) else None)
            if isinstance(snap, dict):
                views = views_from_snapshot(snap)
                if views:
                    out.append((f"config {cfg}", views, _tsecs(snap)))
        return out
    if "reason" in data or "threads" in data or "watchdog_events" in data:
        snap = data.get("metrics") or {}
        return [(data.get("reason", "dump"),
                 views_from_snapshot(snap), _tsecs(snap))]
    return [(os.path.basename(path), views_from_snapshot(data),
             _tsecs(data))]


def _views_live(connect: str, ticks: int, interval: float):
    """Pull each fleet node's snapshot over throwaway metrics-pull
    clients; returns (views, now) with now = wall time (live ages)."""
    from .fleet import connect_sources

    from .traceplane import merge_sections, sections_from_snapshot

    conns, close = connect_sources([a for a in connect.split(",") if a])
    try:
        for _ in range(max(1, ticks)):
            for _name, conn in conns:
                try:
                    conn.request_metrics()
                except Exception:
                    pass
            time.sleep(interval)
        parts = []
        tparts = []
        for name, conn in conns:
            snap = conn.peer_metrics
            if isinstance(snap, dict):
                parts.append(views_from_snapshot(snap))
                tparts.append(sections_from_snapshot(snap))
        return merge_views(parts), merge_sections(tparts), time.time()
    finally:
        close()


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="automerge_tpu_torch.perf explain")
    ap.add_argument("doc", nargs="?", default=None,
                    help="doc id to explain (omit for the hot list)")
    ap.add_argument("--post-mortem", default=None, metavar="PATH",
                    help="a bench detail, flight-recorder dump, or "
                         "raw metrics snapshot (default: the port's "
                         "bench detail)")
    ap.add_argument("--connect", default=None,
                    help="live mode: comma-separated host:port nodes "
                         "to pull ledgers from")
    ap.add_argument("--ticks", type=int, default=2)
    ap.add_argument("--interval", type=float, default=0.3)
    ap.add_argument("--limit", type=int, default=8,
                    help="hot-list rows (no-doc mode)")
    ap.add_argument("--k", type=int, default=None,
                    help="per-ledger doc export cap override (default: "
                         "the ledger's export_k, which honors "
                         "AMTPU_DOCLEDGER_K); also raises the hot-list "
                         "row limit")
    ap.add_argument("--tenant", default=None, metavar="ID",
                    help="restrict the hot list to docs resolving to "
                         "this tenant id (sync/tenantledger.py prefix "
                         "rule; no-doc mode only)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    if args.k is not None:
        # a caller asking for a deeper export wants to SEE it too
        args.limit = max(args.limit, args.k)

    now = None
    if args.connect:
        views, tsecs, now = _views_live(args.connect, args.ticks,
                                        args.interval)
        view_sets = [(None, views, tsecs)]
    else:
        path = args.post_mortem or history.detail_path()
        if not os.path.exists(path):
            print(f"perf explain: nothing to read ({path} missing; run "
                  "bench.py, or pass --post-mortem/--connect)")
            return 0
        try:
            view_sets = _post_mortem_view_sets(path)
        except (OSError, ValueError) as e:
            print(f"perf explain: cannot read {path}: {e}",
                  file=sys.stderr)
            return 2
        if not view_sets:
            view_sets = [(None, {}, {})]
    out_json: list = []
    for label, views, tsecs in view_sets:
        if args.doc is None:
            if args.json:
                out_json.append({"set": label,
                                 "hot": hot_docs(views,
                                                 limit=args.limit,
                                                 tenant=args.tenant)})
            else:
                lines = hot_lines(views, limit=args.limit,
                                  tenant=args.tenant)
                if label and len(view_sets) > 1:
                    lines[0] += f" [{label}]"
                print("\n".join(lines))
            continue
        report = explain_doc(args.doc, views, now=now)
        if label:
            report["set"] = label
        if args.json:
            out_json.append(report)
        else:
            lines = report_lines(report)
            lines.extend(trace_stage_lines(args.doc, tsecs))
            if label and len(view_sets) > 1:
                lines[0] += f" [{label}]"
            print("\n".join(lines))
    if args.json:
        print(json.dumps(out_json[0] if len(out_json) == 1 else out_json,
                         indent=1, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
