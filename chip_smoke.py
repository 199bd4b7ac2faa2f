#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases, each fatal on failure (the script then exits nonzero):

1. the card's name and power limit (as nvidia-smi reports them), the
   torch/CUDA versions, and the kernel build from csrc/ (seconds, and
   ptxas' registers and spills; A's and C's with their shared memory);
2. kernel A (ed25519_challenge) against its plain version: 1, 32 (one
   warp), 37, 512 and 8192 lanes of 44-byte messages plus lanes of 0 and
   47 bytes, exactly equal, and equal to hashlib on a sample;
3. kernel B (ed25519_verify_ladder) against its plain version, run on the
   card: 1024 lanes with every adversarial kind, exactly equal, and equal
   to the pure-Python oracle (phase 5 repeats this at 8192 lanes);
4. the main path: a DeviceScheduler on the card serves a backlog of
   69,410 signatures in 26 requests from four threads across the three
   priority classes (sizes 1 to 8192, one request of variable-length
   messages on the host-hash route); every row must settle on the device,
   both kernels' launch counters (zeroed just before) must have risen, and
   every verdict must equal the oracle where the cofactorless rule and the
   cofactored rule of full buckets agree (a batch that fills its bucket
   takes the cofactored one); of the rows where they differ it prints how
   many took each. The same backlog is then served
   twice more, for the steady rate and under torch.profiler for the
   device's busy share, with the same checks. Kernel A is then held
   against its plain version and hashlib at every batch size the path
   launched it at in the three passes (each batch's pad bucket, from the
   requests that rode in it; as many of the first pass's as A's launches);
5. times at B = 8192 (each kernel on the card, with the stream held while
   the host queues its runs, and kernel A's host time a call; each plain
   version from CUDA events) and the end-to-end rate through the
   scheduler, each beside the card's name and power limit; the bound of
   each kernel; kernel A's time at B = 1, 32, 512 and 8192 beside its
   bound and its serial floor (the rounds warp's chain at one
   scheduler's rate); the ladder's time per launch at 1024, 8192 and 32768
   lanes; the host's prep and enqueue time for one 8192-row bucket (a
   full bucket: the cofactored rule's prep);
6. kernels C (sha256_leaves) and D (sha256_merkle_sweep) against their
   plain versions and hashlib: 8,192 messages of 0-1,100 bytes with every
   padding boundary, and one sweep of two levels (8,192 pairs, then 4,096
   of their parents);
7. kernel E (ed25519_comb) against its plain version and the pure-Python
   oracle on 1,024 lanes (0, 1, L - 1, 2^252, 2^256 - 1, 16^k * j for
   every window k and scalars whose digits fall in one quad's windows among
   them), and ed25519_sign_batch on the card byte-equal to the oracle's
   signer on 256 signatures;
8. the notary path: a BatchedNotaryService(validating=False) on the card
   notarises 24,576 Cash moves signed by Alice (signed on the card by
   kernel E) plus one request of each adversarial kind (the three
   contract-invalid ones, which it signs, among them: the stream is the
   one phases 13, 19 and 20 take), through
   process_stream over windows of 2,048 at depth 3. Every request must
   come back as its expected kind, every signature must verify (all
   through the port's verify path, 512 through the oracle, over ids the
   host recomputes), the launch counters of kernels A to E (zeroed just
   before) must all have risen, and kernel D must have launched once for
   each id sweep of the pass. It prints notarised tx/s for a first and a
   steady pass, the device's busy share over a profiled pass, the host
   time per window of the id sweep's prep, the commit and the signing's
   host half. Then it holds C, D and E against their plain versions at one
   window's shapes (D's whole sweep in one launch), holds D and the ids on
   the card against the host's on a cohort led by the stream's issue (a
   group of 24,580 components), and prints each kernel's time on the card
   and the host's time a call against its bound and its plain version, the
   share of E's time that its inversion takes (csrc/fe_chain_probe.cu), and
   ptxas' report for C, D and E. It also holds C against its plain version
   and hashlib at 2,048 and at 32 leaves of 13 blocks and on the deep
   cohort's leaves, and prints C's time at the window's leaves and at both
   of those beside its serial floor (the longest message's rounds on the
   consumer warp at one scheduler's rate);
9. kernel F (ecdsa_verify_k1, ecdsa_verify_r1) against its plain version
   on the card, each curve: 1,024 lanes with every adversarial kind of
   testing.ecdsa_adversarial_lanes, exactly equal, and equal to the
   pure-Python oracle on a sample of 512, then the same at the main path's
   shape (those lanes tiled to 1,365 and padded to 8,192); ptxas' report
   for it and each block's dynamic shared memory (its k*Q tables); its
   time at B = 512,
   1,365 and 8,192 lanes and at the main path's shape (1,365 signatures
   padded to 8,192 lanes) against its bound, and the plain version's time;
10. the mixed-scheme path: a DeviceScheduler on the card serves bench.py's
   whole MIXED_COMPOSITION (2,048 ed25519, 512 secp256k1, 512 secp256r1,
   8 SPHINCS and 8 RSA rows, 16 keys a scheme, fewer where a scheme has
   fewer rows), tiled 8 times to 24,704 rows with the adversarial ECDSA,
   SPHINCS and RSA lanes at known positions, in 14 requests of 1 to 8,192
   rows from four threads across the three classes. Every verdict must
   equal the oracle, every row but the RSA ones (which the host settles,
   as in the reference) must settle on the device, and the launch counters
   of A, B, both halves of F and H (zeroed just before) must all have
   risen. It prints sigs/s for a first and two steady passes, and for
   two passes of the three-scheme cut (the same rows less SPHINCS and RSA,
   every verdict equal to the oracle) in the same scheduler, the device's busy share over a profiled pass by name (H
   included), the padded share of the lanes, and the host prep of one
   8,192-row mixed batch, with its ECDSA prep, its SPHINCS prep and its
   RSA bucket;
11. the four verify ladders, kernel B (ed25519_verify_ladder and
   ed25519_verify_ladder_w4: the radix-8192 tier, the comb and the 16-entry
   window) and kernel G (ed25519_verify_g8, ed25519_verify_g4: the
   radix-4096 tier, both shapes), against their plain versions on the card:
   phase 3's 1,024 lanes with every adversarial kind, exactly equal, and
   equal to the oracle; their times from CUDA events in turns at B = 1,024,
   8,192 and 32,768, each with its bound and share of it, the plain
   versions' times, ptxas' report (registers, spills, stack frame) and
   each block's dynamic shared memory as the launch sets it; then each
   kernel again against its plain version's result at 8,192 lanes (the
   run that timed it) and that result tiled at 1,024 and 32,768 lanes,
   and that plain result against the oracle tiled;
12. phase 4's backlog through a DeviceScheduler of Ed25519Tier(4096, 8):
   every verdict equal to the oracle as in phase 4, every row settled on
   the device, G's launch counter risen and B's not; sigs/s for a first and
   a steady pass and the device's busy share over a profiled pass;
13. the validating notary: BatchedNotaryService(validating=True) over
   phase 8's stream (24,576 Cash moves plus every adversarial kind, the
   contract-invalid ones included), windows of 2,048 at depth 3, on each
   of the four tiers
   (radix 8192 and radix 4096, each with the comb and with the 16-entry
   window). Every request
   must come back as its expected kind, the answers of the tiers must be
   equal request for request (signature bytes included), and the launch
   counters of A, C, D, E and the tier's ladder (zeroed just before) must
   have risen while the other ladders' stayed at 0. It prints notarised
   tx/s for a first pass on each tier (after a warm-up over two windows),
   and on the default tier (B8) the host ms per window of each stage over
   that pass, the validation stage's (to_ledger_transaction and
   verify_ledger_batch) among them;
14. full ed25519 buckets under the cofactored rule of the reference's RLC
   route, on each of the four tiers: phase 3's lanes plus the 8 small-order
   encodings as A and as R and an R of small order that the cofactorless
   rule accepts, tiled to 8,192 rows. A full bucket through
   dispatch_signature_rows must equal the port's verify_single row by row
   (the tier's ladder launched, the others not), the ladder's cofactored
   launch its plain version at 1,024, 8,192 and 32,768 lanes, and a
   partial bucket the cofactorless oracle; it prints each ladder's time in
   both modes, in turns;
15. the back-chain resolve (BASELINE config #4): verify_transaction_dag on
   the card through the shared scheduler over testing.back_chain(1000), an
   issue and 1,000 self-moves of Cash (1,001 transactions and signatures,
   four windows of 256 at depth 3, every id cache cold on every pass). The
   result (order, levels, signatures, consumed set) must equal the port's
   host route (use_device=False), every primed id must equal hashlib's id
   of the same bytes, the launch counters of A, C, D and B (zeroed just
   before) must rise while the other ladders' and E's stay at 0, and the
   scheduler's batch counter must rise. It prints resolved tx/s for a first
   pass and the median of three steady passes with their spread, the
   card's busy share over a profiled pass, and the host ms a window of each
   stage over a pass of its own (level sort, id plan and enqueue, flatten
   and submit, id collect, verdict collect, consumed set and resolution,
   to_ledger_transaction + verify_ledger_batch). The same checks on a
   GeneratedLedger DAG of 1,024 transactions and 8 parties, on kernel B
   and on kernel G (radix 4096, comb). Then each failure kind on the card:
   a forged chain link in window 2 raises at its own window and leaves no
   claimed id cached, a tampered signature, a double spend, an orphan and
   a non-conserving Cash move raise, and a CommercialPaper issue, move and
   redemption with its Cash resolves as on the host;
16. kernel H (sphincs_verify) alone: against its plain version on the
   card (run at 32 and 64 lanes; 8 against the first lanes of the 32-lane
   run, whose lanes are the same), exactly equal, at 8, 32 and 64 lanes,
   and against the host engine (sphincs.verify) at 8, 32, 64 and 1,024
   lanes of a few distinct signatures tiled with every adversarial kind
   of testing.sphincs_adversarial_lanes; ptxas' report and each block's shared memory; its
   time on the card and the host's time a call at 8, 32 (the mixed path's
   bucket), 64 and 1,024 lanes of valid signatures, each beside its bound
   (the SHA-256 blocks those lanes need, chain steps from each digit
   only, the digits read from the plain version's stages, against the
   bytes), its serial floor (the longest lane's critical chain of
   operations in the redesigned kernel at one scheduler's rate,
   ``sphincs_chain_ops``, beside the one-thread design's chain of dependent
   blocks), its plain version's time (at 32 and 64 lanes) and the host
   route's (sphincs.verify a lane, pure Python);
17. the verifier service: ``testing.service_stream(4096)`` (about three
   quarters single-signer ed25519 Cash moves, an eighth owned by composite
   keys, AND, 2-of-3 and a nested weighted tree over ed25519 and
   secp256k1 leaves, 4 SPHINCS and 3 BLS signers, single-signer
   secp256k1 and secp256r1 moves for the rest in equal numbers, as
   bench.py's ``MIXED_COMPOSITION`` has them, 32 moves whose contract an attachment
   carries, and one of each adversarial kind: a composite threshold short
   by one, a forged leaf, a BLS signature over the wrong message, a
   hostile attachment, a broken HashAttachmentConstraint, a composite key
   as an individual signer, an unknown contract), submitted from 8
   threads through ``BatchedVerifierService.verify_signed`` with contracts
   run, every id cold each pass. Every future's outcome (None, or the
   error's type and failing keys) must equal the stream's oracle (and the
   host route, ``use_device=False``, must too over the first
   ``SERVICE_HOST_EACH`` transactions of each kind), with ``stats`` adding
   up (signature rows; rows on the card, all but the BLS rows), on the
   scheduler route on B8 (the launch counters of A, B8, F and H risen,
   every other kernel's at 0), again on G8 (G8 risen, B8 not) and on the
   windowed route (``use_scheduler=False``, ``window_s=0.005``, as B8),
   there without the composite key as a signer: it fails its whole
   window, as in the reference, and is held apart in one window of
   ``SERVICE_WINDOW`` requests that must fail whole on the card and on the
   host route. It
   prints verified tx/s for a first pass and a steady pass, the card's
   busy share over a profiled pass,
   the host ms a scheduler batch of flatten and submit, collect, signer
   algebra and the contract run (summed over the threads, so waits for
   the interpreter lock count), and the host seconds on one thread of the
   ids and signable bytes, the BLS rows and the contract run. With the
   secp256k1 bucket's dispatch made to fail (``_dispatch_bucket`` patched
   in this script), every request of 512 that was batched with a
   secp256k1 row fails with the error on both routes: nothing fails over
   to the host. Then 256 tear-offs (``FilteredTransaction``) verify
   against their transactions' ids, and a tampered component and a hidden
   group raise;
18. the resolve flow between two nodes (BASELINE config #4 as the flow
   runs it): a ``MockNetworkNodes`` on the card, over a pumping
   ``InMemoryMessagingNetwork``, whose sender holds
   ``testing.back_chain(1000, notarised=True)`` (every move also signed by
   the notary, as a chain that went through finality is); a fresh receiver
   node (ids cold, its key the chain owner's) runs
   ``ReceiveTransactionFlow(record=True)`` against the sender's
   ``SendTransactionFlow`` for the tip: 1,000 fetch rounds, the port's
   ``verify_transaction_dag`` on the card, ``record_transactions``, and the
   top-level check through the shared scheduler's INTERACTIVE class. The
   flow's result must be the tip, the receiver's recording order the
   direct ``verify_transaction_dag``'s order (equal to the host route's)
   then the tip, its vault the tip's output unconsumed and the chain's
   spent, and the launch counters of A, B8, C and D (zeroed just before)
   risen, the other ladders' and E's at 0. It prints resolved tx/s (1,001
   transactions) for a first pass and a steady pass, the host ms of
   the first pass by stage (the fetch
   rounds, ``verify_transaction_dag``, ``record_transactions``, the
   top-level check, from its ``flow.verify_stx`` trace spans), and the
   card's busy share of a profiled pass; every pass beside its flows'
   parks (a wait past the mock network's 1 s parking grace parks a flow,
   which resumes by replaying its op log). (b) A ``GeneratedLedger`` DAG of 512
   transactions under a tip that spends every state it left, resolved by a
   receiver on B8 and one on a G8 hub: each equal to the direct resolve,
   the two equal, B8's or G8's counter risen. (c) Each failure kind fails
   the flow with the reference's error: a sender that substitutes a
   transaction, a forged signature deep in the chain, a double spend inside
   the fetched DAG, a vend probe for a transaction outside the chain, and a
   closed scheduler sheds the top-level check to the host check, as the
   reference's does: the flow completes and each ``flow.verify_stx`` span
   reads ``degraded=host-fallback``. (d) Sixteen receivers resolve sixteen distinct 64-hop chains at
   once: every outcome checked, and the scheduler batches against the
   requests (its counters), the top-level checks (INTERACTIVE) apart (the
   batch each one's ``flow.verify_stx`` span names);
19. notarisation (BASELINE config #5 on one notary). (a) ``tools.loadtest``'s
   ``notary_service_storm_test`` (bench.py's ``bench_notary_loadtest``
   shape: 8 injectors of 128-transaction chunks, ``RunParameters(
   parallelism=8, generate_count=24)``) against a validating
   ``BatchedNotaryService.request()`` on the card (B8,
   ``PersistentUniquenessProvider``, ``max_batch`` 2,048, ``window_s``
   0.005) over phase 8's stream, ``testing.notary_stream(24576, 2048,
   contract_invalid=True)``
   with its adversarial kinds, ids cold each pass; the storm's model
   counts the requests submitted and its gather the committed ones plus
   the refusals expected. Every answer must be its request's kind, every
   signature must verify on the card, the committed count the model's,
   the launch counters of A, B8, C, D and E risen and no other; a sample
   in stream order (every adversarial request, the moves they
   double-spend, a stride of moves) answered by the host tier
   (``use_device=False``) must give the same signature bytes and
   conflicts. The accepted requests the signed cache holds, resubmitted,
   are answered from it (at the door, and fresh copies after their
   window's id sweep) with the original bytes, no commit and no launch of
   E; evicted ones take the whole path and get the same bytes. It prints
   notarised tx/s for a first pass (with a fresh provider; its steady
   rate is phase 25a's pass with every layer off), the windows and their
   sizes, request-to-result latency p50 and p99, the host ms a window of
   each stage over the first pass (the flusher's take,
   ``dispatch_ids``, ``dispatch_batch``, ``settle_validate``,
   ``settle_sign``, ``finalize_batch``), the card's
   busy share of a profiled pass; a pass on G8 (every answer B8's, G8
   launched and B8 not); a burst of 16 windows of 256 in flight at once;
   and beside them ``process_stream``'s rate on the same stream and the
   sequential ``ValidatingNotaryService.process`` over 256 moves of one
   window. (b) ``notarisation_storm_test`` between four parties and a
   notary node running ``BatchedNotaryService`` on the card (B8,
   ``window_s`` 0.005) on a ``MockNetworkNodes``: 64 issue-and-move
   pairs (``CashIssueFlow``, ``CashPaymentFlow``: ``FinalityFlow``, the
   notary flows, the broadcast) from 8 injectors, one pair at a time a
   paying node, the network's deliveries stalled for 0.1 s in the second
   generation. The model must reconcile, the notary's committed count
   equal the moves, every vault's balance the model's, a second move of a
   spent state fail with ``NotaryException``, and A, B8, C, D and E
   launched. It prints finalised payments a second, every node's parks,
   and three payments alone by part (the payer's checks, the notary round
   trip, the notary's resolve, the record, the broadcast and, inside it,
   the recipient's resolve, check and record).
20. the notary clusters (BASELINE config #5 as named: bench.py's
   ``bench_notary_raft_cluster`` and ``bench_notary_bft_cluster``). Phase
   8's stream, ids cold each pass, through a validating
   ``BatchedNotaryService`` on B8 (``max_batch`` 2,048, ``window_s``
   0.005, ``process_stream`` at depth 3) committing each window as one
   consensus round: (a) through a 3-replica Raft cluster on an in-memory
   network (``RaftUniquenessProvider.make_node_on_endpoint``: election
   timeout 1-2 s, heartbeat 0.25 s; each provider's submit window 10 s as
   bench.py sets it) and (b) through a
   4-replica BFT cluster with BLS quorum certificates
   (``BFTUniquenessProvider.make_cluster``, the client's quorum wait 30
   s, the replicas' view timeout 10 s). Every answer must equal, slot for slot, the single notary's
   (``PersistentUniquenessProvider``) to the same stream in the same call;
   the first pass must make one Raft log entry or one BFT slot a window,
   leave every replica's consumed set equal to the single notary's, launch
   A, B8, C, D and E and no other kernel, and (BFT) cache one certificate
   a window beside every accepted id, each verified. It prints notarised
   tx/s for a first pass and (Raft) a steady pass, each on a fresh
   cluster, beside the
   single notary's; each pass's elections (its term at the start and the
   end; a window may stand twice in the log only when the term rose) or
   view changes, and its longest round; the host ms a window of the replication round (the
   pending commit's ``collect``), of the command's serialization, of the
   replicas' apply or execute and (BFT) of the certificate's build and
   check. (c) Over the stream's first five windows, the Raft leader is
   stopped once the third window has committed (the notary commits
   through a follower, which forwards): a new leader is elected and the
   windows complete with the single notary's answers; then a BFT backup,
   and in another pass the BFT primary, are stopped likewise (a view
   change follows): the same answers, the survivors' consumed sets equal.
   (d) ``tools.loadtest``'s service storm (19a's shape) through
   ``request()`` on the Raft-backed notary, profiled for the card's busy
   share: its model reconciles, every answer its kind.
   (e) ``samples.notary_demo.run_demo()`` on the card, all four modes
   (single, Raft, BFT, the batched notary over Raft): the same counts in
   every mode, the double spend refused.
21. the trader demo (BASELINE config #1, ``bench.py::bench_trader_demo``):
   on a ``MockNetworkNodes`` on the card, a seller and a buyer; the buyer
   issues itself 1,500 GBP and the seller a commercial paper for each of
   48 trades (untimed, 16 at once), then 48 ``SellerFlow`` offers at once
   (offer, swap, notarise, broadcast; timed, the card's activity
   profiled) against a validating ``BatchedNotaryService`` node (B8,
   ``PersistentUniquenessProvider``, ``max_batch`` 2,048, ``window_s``
   0.004). Every trade must settle, the buyer hold 48 papers and the
   seller 48 x 900 GBP, A, B8, C, D and E be launched and no other. The
   same trades against the reference's host shape
   (``create_notary_node(validating=True)``), and
   ``samples.trader_demo.run_demo(n_trades=1)`` on the card (the
   reference's summary less ``elapsed_s``). It prints trades/s for both
   notaries, the card's busy share and the launches.
22. the out-of-process verifier: two ``python -m
   corda_tpu_torch.verifier.worker`` processes on the card over one
   ``DurableQueueBroker`` file in a temporary directory (``--cordapp
   corda_tpu_torch.finance``), fed by ``OutOfProcessVerifierService``
   from this process with the first 2,048 of phase 17's transactions
   whose contract no attachment carries (a worker has no attachment
   store).
   Every verdict must equal phase 17's, no request go unanswered or
   dead-letter, the workers' launches (their ``--report``) count A, B8,
   F-k1, F-r1 and H, and each worker exit with rc 0 on an interrupt. It
   prints verified tx/s beside phase 17's steady rate.
23. the durable notary: the first eight windows of phase 8's stream
   (16,384 requests) through a validating
   ``BatchedNotaryService`` on B8 over ``PersistentUniquenessProvider``
   (the answers every later pass must give, and its rate), then over
   ``DurableUniquenessProvider`` with its WAL in a temporary directory
   (answers and consumed-set digest equal; A, B8, C, D, E launched, no
   other; its rate, fsyncs and fsync ms a window); then window by window
   with a ``faultinject`` crash at ``durability.wal.post_fsync`` in the
   fourth window: the provider and service are rebuilt from the
   directory alone (the recovery's seconds), every acknowledged
   attestation must come back from the journal, the unanswered windows
   are resubmitted and every answer, slot for slot, and the digest must
   equal the single notary's, 64 acknowledged requests retried through
   ``request()`` must get their original answers and signature bytes,
   and a double spend must be refused. Then the exit probe: a process
   submits 16,384 ed25519 rows to the card's shared scheduler and exits
   at once with them in flight: rc 0, no ``terminate called``.
24. the device state store (``statestore/``: kernels I, J and K). (a)
   Kernels I (``statestore_probe``), J (``statestore_commit``) and K
   (``statestore_remove``) against their plain versions on the card: one
   seeded op sequence on two tables of 2^14 slots, one through the
   kernels and one through the plain versions, at max_probe 32 and at
   max_probe 8 crowded onto 1,024 home slots until windows overflow (8,192
   commit rows in four batches of 1,024 requests of 2 refs, 10%
   conflicting and 5% identical retries, 2,048 removes with keys twice and
   absent keys, a batch re-inserting removed keys over their tombstones,
   probes): every verdict, overflow, removed and found bit and every word
   of keys, txs and tags equal. Then, with every launch counter zeroed,
   the main path: (b) phase 8's stream through a validating
   ``BatchedNotaryService`` (B8) over ``DeviceShardedUniquenessProvider``
   on the card (2^20 slots): every answer equal, slot for slot, to the same
   notary's over ``InMemoryUniquenessProvider``, ``consumed_digest`` equal,
   ``device_divergence`` 0, the spills printed; notarised tx/s first and
   steady beside the in-memory provider's, the commit's host ms a window
   and kernel J's device ms a window (a profiled pass). (c) A scale-mode
   provider (``shadow=False``) over 2^23 slots (570 MB), preloaded with
   4,000,000 seeded rows through ``insert_rows`` in batches of 65,536 (its
   rate printed), then 64 batches of 4,096 ``stream_commit_requests(seed=
   2026, double_spend_fraction=0.002)``: every flagged double spend
   conflicts and nothing else; 8,192 preloaded rows probe present and
   8,192 fresh rows absent; I at those 8,192 rows, J at one more batch of
   4,096 requests and K at the 8,192 rows timed at that load, each held
   against its plain version there, beside its bound; one batch of 65,536
   fresh rows (a preload batch) through J in its rounds and through the
   same launch forced to walk every row: tables, outputs and bucket marks
   equal. J and K print their rows freed in each round, their rows walked
   and their serial floor (rounds plus walked rows, times one dependent
   load: a one-thread chase over 32 MB); they are timed with the stream
   held, on the table whose windows are put back from a saved copy, and
   the L2 cache flushed, before each run. Once closed and dropped, the
   provider's table leaves the monitoring section and its memory on the
   card is freed. (d)
   A shadow provider over a ``DurableStore`` under the notary for four
   windows, dropped without ``close()`` and rebuilt from its directory:
   the digest equals the in-memory oracle's and a double spend of a
   recovered ref is refused by a device probe (the rebuild's seconds
   printed). (e) A mock network on the card with ``CORDA_TPU_STATESTORE``
   on: every node's vault keeps its index on the card; after Cash issues
   and payments each index's membership equals ``unconsumed_ref_exists``
   (SQL) and its ``owner_count`` the node's live states. I, J and K must
   all have launched in (b)-(e). Each part prints its time.
25. the host observability layers. (a) Phase 19a's storm (phase 8's
   stream from 8 injectors into ``BatchedNotaryService.request()`` on B8)
   once with every layer off and once with netstats, flowprof, contention
   (``install()``ed), cluster, the SLO monitor (fed each answer's latency)
   and the timeline on: the answers must be equal request for request,
   signature bytes and conflicts included, and A-E must launch; it prints
   tx/s, p50 and p99 off and on. Four payments between two nodes of a mock
   network on the card (a batched notary node) follow with the layers on;
   then each layer's ``monitoring_snapshot()`` section must read enabled
   and hold what it recorded, ``metrics_text()`` must parse line by line
   with the ``net``, ``slo`` and ``contention`` families, and a
   ``flight_dump()`` must hold every kind the reference writes.
   Everything is turned off and contention uninstalled;
   then contention's cost an operation (a lock's acquire and release, a
   ``Future`` made and set, a ``Queue`` put and get; off, then installed)
   and the reference's budget runs, timed here: the stack sampler's
   overhead at 100 Hz over three busy threads, classifier off and on, and
   1,500 messages through the SQLite broker and the native queue. (b)
   ``tools.loadharness.run_harness`` at the reference's defaults but the
   step (4, 8 and 16 qps, 3 s a step for the script's time where the
   reference takes 5, Cash payments between three nodes of a mock
   network on the card, flowprof and netstats on): each step's offered,
   completed, shed, error rate, p50, p99, retransmits and transit p99, the
   knee, whose waterfall must sum to its wall within 5%; the LOADTEST
   payload must pass ``tools_perf_gate.py --check-schema``, and kernels A
   and B (counters zeroed just before) must have launched.

26. multi-device serving (at most 45 s). (a) The mesh on the card's one
   ordinal: ``MeshVerifier.dispatch_rows`` with and without spent rows on
   phase 3's lanes (every adversarial kind): the mask equal to the oracle
   and to the plain ladder, ``spent_all`` equal to the rows given,
   ``total`` to the mask's count; ``dispatch_ecdsa_rows`` on both curves
   and ``dispatch_sphincs_rows`` against the oracle on their adversarial
   lanes; phase 10's distinct ``MIXED_COMPOSITION`` rows through
   ``dispatch_signature_rows`` with ``enable_service_mesh(True)``, every
   verdict the oracle's and A, B, F (both curves) and H launched. (b) A
   striped scheduler (``mesh=True``, one ordinal) with a
   ``ResiliencePolicy``: a clean pass (no hedge, failover or shed), an
   injected stall (the hedge fires and, with no sibling, the host settles
   it; the late readback is discarded), injected dispatch faults (the
   breaker opens, the batch fails over, the canary on the card closes
   it); every verdict the oracle's, each counter printed. (c) A
   mega-batch on two logical ordinals of the card: phase 3's lanes fused
   over both, the consumed rows gathered onto each and the accept count
   summed, and the state store's screen (kernel I a shard of a table
   striped over the two, preloaded through J's check and J, held against
   its plain versions' table) counting the gathered rows it holds, equal to
   the host's count; the step's time and the gather's against its bound.
   A logical mesh on one card measures no collective across cards. (d)
   The profiler and devicemon on: A, B, C, D, E, F and H each one compile
   and then execute observations a kernel x bucket (CUDA events),
   devicemon's dispatches equal to kernel B's launches in four scheduler
   batches, and ``monitoring_snapshot()`` with its ``resilience`` and
   ``profiler`` sections. It prints its time.

27. the node and its RPC (at most 40 s). Three ``Node``s (Alice, Bob and a
   validating notary over the device state store, ``DeviceBatched``
   verifiers) built from one HOCON text through ``load_config`` on the
   in-memory network run ``NODE_PAYMENTS`` Cash issues and as many
   concurrent payments through a ``CordaRPCClient`` with the reference
   test's users and permissions (the user without permission refused, the
   hashed one let in), a vault query and ``profiler_snapshot()`` over RPC
   (its ``roofline_rows_per_sec`` for the ed25519 verify and the
   challenge); kernels A, B or G and J must launch (counters zeroed just
   before). A twin of the story at ``NODE_TWIN_PAYMENTS`` on the card must
   equal the same story with ``device="cpu"``, which runs in a process of
   its own at the lowest priority from before phase 1's build. Then one
   node runs as its own process (``python -m
   corda_tpu_torch.node.startup`` over a broker file, on the card) and
   answers one flow over RPC. (b) The host anchor: ``host_ref.verify_loop``
   over phase 3's 1,024 triples (verdicts equal to the oracle), its sigs/s
   with the host's CPU beside kernel B's at the same rows on the card. It
   prints its time.

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, the script exits nonzero before any
result.

    python3 chip_smoke.py --ladders TREE

runs phases 11 and 9 alone (the ed25519 ladders, then kernel F on both
curves), as the chip_smoke.py of TREE (a checkout of this repository, of
this commit or another) does them, on that tree's kernels: to compare two
commits' ladders on one card, unpack the other with ``git archive`` into a
directory ``.gitignore`` lists and run, in one call, ``--ladders OTHER``,
``--ladders .``, ``--ladders .``, ``--ladders OTHER``.

    python3 chip_smoke.py --notary-kernels TREE

times the notary's signing and id kernels on TREE's package and kernels,
with this script's timer (the card's time, the stream held while the host
queues the runs, beside the host's time a call): kernel E at one window's
2,048 lanes, and kernel D over the Merkle levels of one window of the
notary stream (2,048 requests): TREE's one sweep launch
(``sha256_merkle_sweep``) where it has one, else its launch a level
(``sha256_pair_level``) over the same plan. Run it as ``--ladders`` is
run, in the order other, this, this, other.

    python3 chip_smoke.py --hash-kernels TREE

holds and times kernels C and A on TREE's package and kernels, each
called as that tree's own paths call it, with this script's timer: C at
one notary window's leaves, at 2,048 leaves of 13 blocks and at one warp
of leaves of 13, 1 and 7 blocks; A at B = 1, 32, 512 and 8,192; with
TREE's ptxas report for both. Run it as ``--ladders`` is run.

    python3 chip_smoke.py --sphincs-kernel TREE

holds kernel H of TREE's package and kernels against the host engine on
every adversarial kind, and times it with this script's timer at 8, 32,
64 and 1,024 lanes of valid signatures, with TREE's ptxas report and
shared memory. Run it as ``--ladders`` is run.

    python3 chip_smoke.py --statestore-kernels TREE

builds phase 24c's table with TREE's package and kernels (its preload's
rows/s printed) and times kernels I (8,192 rows), J (24c's batch of 4,096
requests, and a preload batch of 65,536 fresh rows) and K (8,192 rows)
there with this script's timers. Run it as ``--ladders`` is run.

    python3 chip_smoke.py --service

runs phase 17 alone (the verifier service) on this tree's kernels.

    python3 chip_smoke.py --resolve-flow

runs phase 18 alone (the resolve flow between two nodes) on this tree's
kernels.

    python3 chip_smoke.py --notary-storm

runs phase 19 alone (the notary storms) on this tree's kernels.

    python3 chip_smoke.py --durable

runs phases 21-23 and the exit probe alone (phase 22 over a stream of its
own, phase 23 over phase 8's stream built first) on this tree's kernels.

    python3 chip_smoke.py --statestore

runs phase 24 alone (the device state store; it builds phase 8's stream
first) on this tree's kernels.

    python3 chip_smoke.py --layers

runs phase 25 alone (the host observability layers and the open-loop
harness; it builds phase 8's stream and warms the storm first) on this
tree's kernels.

    python3 chip_smoke.py --mesh

runs phase 26 alone (multi-device serving) on this tree's kernels.

    python3 chip_smoke.py --node

runs phase 27 alone (the node, its RPC and the host anchor; it builds
phase 3's pool first) on this tree's kernels.

    python3 chip_smoke.py --notary-cluster

runs phase 20 alone (the notary clusters; it builds phase 8's stream
first) on this tree's kernels.

    python3 chip_smoke.py --sphincs-stages TREE

builds a copy of TREE's kernel H that stamps the SM clock after each
stage's barrier and prints each stage's median clocks over the blocks at
32 and 1,024 lanes (stage 0 the FORS trees, 1 the FORS pk, then each
layer's chains and its WOTS pk and auth path).
"""

from __future__ import annotations

import contextlib
import cProfile
import functools
import hashlib
import json
import pstats
import random
import subprocess
import sys
import threading
import time

NOTARY_TXS = 24576     # bench.py's notarisation stream
NOTARY_WINDOW = 2048   # bench.py's NOTARY_CHUNK
NOTARY_DEPTH = 3
SHA_LANES = 8192
SHA_BOUNDARIES = [0, 1, 55, 56, 63, 64, 65, 119, 120, 127, 128, 1100]
COMB_LANES = 1024
SIGN_SAMPLE = 256
ORACLE_SAMPLE = 512

ECDSA_LANES = 1024      # phase 9's lanes a curve
ECDSA_SHARE = 1365      # a curve's rows in an 8,192-row mixed batch
MIXED_TILE = 8          # phase 10: 3,088 distinct rows x 8 = 24,704
MIXED_SIZES = [8192, 6128, 4096, 3000, 1500, 1024, 300, 256, 100, 64, 33, 8, 2, 1]
H_SIZES = (8, 32, 64, 1024)   # phase 16: kernel H's lanes
H_PLAIN_MAX = 64              # and the largest of them held against the plain version
                              # (its run takes about 20 s at any width: the script's time)
H_MIXED_BUCKET = 32           # the mixed path's bucket of SPHINCS rows

G_SIZES = (1024, 8192, 32768)  # phase 11's lanes a launch

A_SIZES = (1, 32, 512, 8192)  # kernel A's held and timed batches; 32 is one warp
C_LONG_BYTES = 800            # a 13-block leaf, as long as a notary window's longest
C_LONG_LANES = (2048, 32)     # a window's count of 13-block leaves, and one warp of them

STEADY_PASSES = 1      # phases 17 and 18: steady passes after the first
SERVICE_TXS = 4096     # phase 17: BatchedVerifierService's default max_batch
SERVICE_THREADS = 8
SERVICE_FAILED_TXS = 512  # the failed-dispatch check's transactions
SERVICE_HOST_EACH = 32    # the host route's transactions of each kind (pure Python: the
                          # whole stream took 46 s of the script's time)
SERVICE_WINDOW = 64       # the window that holds the composite key as a signer
FILTERED_TXS = 256

RESOLVE_HOPS = 1000    # BASELINE config #4: a 1k-hop Cash back-chain
RESOLVE_WINDOW = 256   # verify_transaction_dag's window and depth
RESOLVE_DEPTH = 3
GEN_TXS = 1024         # phase 15's generated DAG (2,048 before the script's time cut it)
FLOW_GEN_TXS = 512     # phase 18's (the script's time: its G8 receiver parks on a slow host)
GEN_PARTIES = 8

MAIN_PATH_SIZES = [8192] * 6 + [6000, 4096, 3000, 2048, 1500, 1024, 777, 512,
                                300, 256, 100, 64, 33, 17, 8, 5, 3, 2, 1]
VAR_REQUEST_ROWS = 512


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def device_times(fn, reps: int) -> tuple[float, float]:
    """(device ms, host ms) per run of ``fn`` over ``reps`` runs, after one
    warm-up run. A sleeping kernel holds the stream while the host enqueues
    every run, so the CUDA events time the runs back to back on the card,
    not the host's rate of launching them (for a kernel shorter than its
    wrapper, back-to-back calls measure the wrapper). The host ms is the
    enqueue time per run. If the hold ran out before the last run was
    queued, it is doubled and the runs repeated."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    hold_s = max(2 * reps * (time.perf_counter() - t0), 1e-3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(6):
        torch.cuda._sleep(int(hold_s * 2e9))  # cycles; at most 2 GHz
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3 / reps
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / reps, host_ms
        hold_s *= 2
    raise AssertionError("the stream's hold ran out before every run was queued")


def cuda_ms(fn, reps: int) -> float:
    """Device milliseconds per run of a kernel's wrapper (``device_times``)."""
    return device_times(fn, reps)[0]


def plain_ms(fn, reps: int = 1) -> float:
    """Mean milliseconds of a plain version over ``reps`` runs, from CUDA
    events around back-to-back calls after one warm-up run (a plain
    version is a long host-driven run of small operations)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def card_rates() -> tuple[int, float, float]:
    """The card's SM count, its maximum SM clock in MHz and its peak rate of
    32-bit integer operations a second."""
    import torch

    from corda_tpu_torch.ops.opcount import INT32_OPS_PER_CLOCK_PER_SM

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(smi("clocks.max.sm").split()[0])
    return n_sm, mhz, INT32_OPS_PER_CLOCK_PER_SM * n_sm * mhz * 1e6


def adversarial_pool(n: int = 1024, seed: int = 7):
    """Phase 3's lanes: one of every adversarial kind of
    ``testing.adversarial_lanes``, then signed triples up to ``n``. Returns
    the kinds, the (pk, sig, msg) triples and the pure-Python oracle's
    verdicts."""
    import numpy as np

    from corda_tpu_torch.crypto import ed25519_host
    from corda_tpu_torch.testing import adversarial_lanes, signed_triples

    lanes = adversarial_lanes(seed)
    pool = [(pk, sig, msg) for _k, pk, sig, msg in lanes]
    pool += signed_triples(n - len(pool), seed=seed)
    return [k for k, *_ in lanes], pool, np.array([ed25519_host.verify(*t) for t in pool])


def fixed_plane(rng: random.Random, n: int, msg_len: int):
    """(n, 161) packed plane of random R, A, s and ``msg_len``-byte messages,
    packed and padded as the fixed-length route does."""
    import numpy as np

    from corda_tpu_torch.ops.ed25519 import pack_rows

    rand = np.frombuffer(rng.randbytes(n * 128), np.uint8).reshape(n, 128)
    msgs = [rng.randbytes(msg_len) for _ in range(n)]
    plane = np.zeros((n, 161), np.uint8)
    pack_rows(plane, rand[:, :64], rand[:, 64:96], rand[:, 96:128],
              np.ones(n, bool), msgs)
    return plane, msgs


def pack_triples(triples, cofactored=False):
    import numpy as np

    from corda_tpu_torch.ops import ed25519 as ed

    pks, sigs, msgs = map(list, zip(*triples))
    pk_arr, sig_arr, ok = ed._gather_fixed(pks, sigs, len(pks))
    _y, _s, s_arr, pre = ed._canonical_precheck(pk_arr, sig_arr, ok, cofactored)
    plane = np.zeros((len(pks), 161), np.uint8)
    ed.pack_rows(plane, sig_arr, pk_arr, s_arr, pre, msgs)
    return plane


def serve_backlog(sched, rows_by_req, classes):
    """Submit every request from four threads and wait for all of them:
    ({request: RowResult}, CUDA-event ms, host-clock ms)."""
    import torch

    futures: dict = {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    wall0 = time.perf_counter()

    def submit(ks):
        for k in ks:
            futures[k] = sched.submit_rows(rows_by_req[k], priority=classes[k])

    threads = [threading.Thread(target=submit, args=(range(t, len(rows_by_req), 4),),
                                daemon=True)
               for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    results = {k: f.result(timeout=600) for k, f in futures.items()}
    end.record()
    end.synchronize()
    return results, start.elapsed_time(end), (time.perf_counter() - wall0) * 1e3


def check_backlog(results, requests, n_rows, device_rows_want=None) -> tuple[int, int]:
    """Every request answered, every row settled on the device (or
    ``device_rows_want`` of them, where host rows ride along), every
    verdict equal to the oracle. A request (rows, want, class, want_cof)
    also carries the cofactored rule's verdicts, which a full ed25519
    bucket takes: where the two rules agree the verdict must equal both,
    and where they differ it takes one of them. Returns how many rows on
    which the rules differ took the cofactored verdict, and how many the
    cofactorless one."""
    if len(results) != len(requests):
        raise AssertionError("not every request was submitted")
    device_rows = 0
    took = [0, 0]
    for k, req in enumerate(requests):
        want_k = req[1]
        want_cof = req[3] if len(req) > 3 else want_k
        got = results[k].mask.tolist()
        if len(got) != len(want_k):
            raise AssertionError(f"request {k}: {len(got)} verdicts for {len(want_k)} rows")
        for i, (g, w, c) in enumerate(zip(got, want_k, want_cof)):
            if w == c and g != w:
                raise AssertionError(f"request {k}, row {i}: verdict differs from the oracle")
            if w != c:
                took[g == w] += 1
        device_rows += results[k].n_device
    want_rows = n_rows if device_rows_want is None else device_rows_want
    if device_rows != want_rows:
        raise AssertionError(f"device_rows {device_rows} != {want_rows} of the {n_rows} rows")
    return took[0], took[1]


def device_busy(prof) -> tuple[float, dict]:
    """(device-busy ms, {kernel or copy name: us}) of a profiled run."""
    device_us = {}
    for evt in prof.key_averages():
        if evt.self_device_time_total > 0:
            device_us[evt.key] = device_us.get(evt.key, 0.0) + evt.self_device_time_total
    return sum(device_us.values()) / 1e3, device_us


def challenge_batches(results, rows_by_req) -> list[int]:
    """Kernel A's batch size in each device batch of one backlog pass that
    launches it, from the batch each request rode in (its ``batch_seq``):
    the pad bucket that the scheduler and the ed25519 dispatch give the
    batch's rows, where they all carry messages of one length of at most
    MAX_FIXED_MSG bytes (the rows are all ed25519)."""
    from collections import Counter, defaultdict

    from corda_tpu_torch.ops._blockpack import bucket_floor, pow2_at_least
    from corda_tpu_torch.ops.ed25519 import MAX_FIXED_MSG
    from corda_tpu_torch.serving.shapes import shape_table

    rows, lengths = Counter(), defaultdict(set)
    for k, rr in results.items():
        rows[rr.batch_seq] += len(rows_by_req[k])
        lengths[rr.batch_seq].update(len(m) for _key, _sig, m in rows_by_req[k])
    table = shape_table()
    return [pow2_at_least(n, bucket_floor(table.bucket_for(n), True))
            for seq, n in rows.items()
            if len(lengths[seq]) == 1 and max(lengths[seq]) <= MAX_FIXED_MSG]


def backlog_passes(dev, rows_by_req, requests, classes, n_rows, kernels, tier=None):
    """The backlog through a DeviceScheduler of ``tier`` three times, each
    pass checked: first with ``kernels``' launch counters zeroed just
    before and read just after, then steady, then profiled. Returns
    (launches, counters, batches, first CUDA ms, first host ms, steady CUDA
    ms, profiler, profiled host ms, check_backlog's split of the first
    pass, and kernel A's batch sizes in each pass)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from corda_tpu_torch.serving import DeviceScheduler

    sched = DeviceScheduler(device=dev, tier=tier)
    try:
        # warm-up: pinned staging buffers and the table's first upload
        sched.submit_rows(rows_by_req[-1]).result(timeout=300)
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        results, e2e_ms, wall_ms = serve_backlog(sched, rows_by_req, classes)
        launches = {k.__name__: k.launches for k in kernels}
        counters = dict(sched.counters)
        # the same backlog twice more, with every bucket's buffers warm:
        # once for the steady rate, once under the profiler for the
        # device's busy share
        steady, steady_ms, _ = serve_backlog(sched, rows_by_req, classes)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled, _, prof_wall_ms = serve_backlog(sched, rows_by_req, classes)
    finally:
        sched.shutdown()
    took = [check_backlog(res, requests, n_rows) for res in (results, steady, profiled)][0]
    batches = sorted({rr.batch_seq for rr in results.values()})
    a_batches = [challenge_batches(res, rows_by_req) for res in (results, steady, profiled)]
    return (launches, counters, batches, e2e_ms, wall_ms, steady_ms, prof, prof_wall_ms, took,
            a_batches)


def bound(bytes_moved, ops, int_rate):
    """(least ms, what bounds it): ``ops/opcount.py``'s rule, bytes over the
    HBM rate against 32-bit integer operations over ``int_rate``."""
    from corda_tpu_torch.ops.opcount import bound as model_bound

    return model_bound(bytes_moved, ops, int_rate)


def serial_floor_ms(chain_ops: int, mhz: float) -> float:
    """The least time of one warp whose lanes each run a serial chain of
    ``chain_ops`` integer operations (``ops/opcount.py``)."""
    from corda_tpu_torch.ops.opcount import serial_floor_ms as model_floor

    return model_floor(chain_ops, mhz)


def print_ptxas(label: str, names) -> None:
    """ptxas' report (entry, registers and shared memory, stack and spills)
    of the kernels whose entry names contain one of ``names``."""
    from corda_tpu_torch.ops import _build

    entry = ""
    for line in _build.build_info.get("ptxas", "").splitlines():
        if "Compiling entry" in line:
            entry = line
        if any(name in entry for name in names) and any(
                w in line for w in ("Compiling entry", "registers", "spill")):
            print(f"ptxas ({label}):", line.strip())


def hold_challenge(dev, rng, n: int, mlen: int = 44):
    """Kernel A against its plain version on ``n`` lanes of ``mlen``-byte
    messages, exactly, and against hashlib on a sample; returns (the
    packed plane on ``dev``, the largest difference)."""
    import torch

    from corda_tpu_torch.crypto import ed25519_host
    from corda_tpu_torch.ops.scalar25519 import challenge_windows_plain, ed25519_challenge

    plane, msgs = fixed_plane(rng, n, mlen)
    packed = torch.from_numpy(plane).to(dev)
    got = ed25519_challenge(packed)
    want = challenge_windows_plain(packed)
    if not torch.equal(got, want):
        raise AssertionError(f"kernel A != plain at {n} lanes, {mlen}-byte messages")
    host = got.cpu().numpy()
    for i in sorted({*range(0, n, max(1, n // 64)), n - 1}):
        h = int.from_bytes(hashlib.sha512(
            plane[i, :64].tobytes() + msgs[i]).digest(), "little") % ed25519_host.L
        if [int(v) for v in host[:, i]] != [(h >> (4 * k)) & 15 for k in range(64)]:
            raise AssertionError(f"kernel A != hashlib at lane {i} of {n}")
    return packed, int((got - want).abs().max())


def hold_leaves(dev, msgs, label: str):
    """Kernel C against its plain version and hashlib on ``msgs``; returns
    (the uploaded blocks, offsets and counts, the digests, the largest
    difference)."""
    import torch

    from corda_tpu_torch.ops import sha256 as sha

    up = sha.upload_messages(msgs, dev)
    got = sha.sha256_leaves(*up)
    want = sha.sha256_leaves_plain(*up)
    if not torch.equal(got, want):
        raise AssertionError(f"kernel C != plain at {label}")
    if sha.digest_words_to_bytes(got.cpu().numpy()) != [hashlib.sha256(m).digest() for m in msgs]:
        raise AssertionError(f"kernel C != hashlib at {label}")
    return up, got, int((got.long() - want.long()).abs().max())


def check_sha256_kernels(dev, rng, n: int = SHA_LANES) -> tuple[int, int]:
    """Phase 6: kernels C and D against their plain versions and hashlib;
    returns each kernel's largest difference from its plain version (0)."""
    import numpy as np
    import torch

    from corda_tpu_torch.ops import sha256 as sha

    lengths = SHA_BOUNDARIES + [rng.randrange(0, 1101) for _ in range(n - len(SHA_BOUNDARIES))]
    msgs = [rng.randbytes(k) for k in lengths]
    (_blocks, _offs, cnts), got, err_c = hold_leaves(dev, msgs, f"{n} messages")
    print(f"kernel C == plain == hashlib: {n} messages of 0-1100 bytes "
          f"({int(cnts.sum())} blocks, boundaries {SHA_BOUNDARIES})")

    # two levels in one sweep over a pool of 2n digests: n pairs of children
    # in shuffled order, then n / 2 pairs of those parents
    pool = torch.cat([got, torch.flip(got, [0]), torch.zeros_like(got),
                      torch.zeros_like(got[: n // 2])]).contiguous()
    perm = np.array(rng.sample(range(2 * n), 2 * n), dtype=np.int32)
    second = np.arange(2 * n, 3 * n, dtype=np.int32)
    pairs = [(2 * n, perm[:n], perm[n:]), (3 * n, second[0::2], second[1::2])]
    levels = [(first, torch.from_numpy(left.copy()).to(dev), torch.from_numpy(right.copy()).to(dev))
              for first, left, right in pairs]
    pool_plain = pool.clone()
    sha.sha256_sweep_plain(pool_plain, levels)
    sha.sha256_merkle_sweep(pool, levels)
    if not torch.equal(pool, pool_plain):
        raise AssertionError("kernel D != plain")
    rows = sha.digest_words_to_bytes(pool.cpu().numpy())
    for first, left, right in pairs:
        if rows[first : first + len(left)] != [
                hashlib.sha256(rows[a] + rows[b]).digest() for a, b in zip(left, right)]:
            raise AssertionError(f"kernel D != hashlib at the level from row {first}")
    err_d = int((pool.long() - pool_plain.long()).abs().max())
    print(f"kernel D == plain == hashlib: one launch of two levels, {n} and {n // 2} pairs")
    return err_c, err_d


def check_comb_kernel(dev, rng, n: int = COMB_LANES) -> int:
    """Phase 7: kernel E against its plain version and the oracle, and
    signing on the card against the oracle's signer; returns the largest
    difference (0)."""
    import numpy as np
    import torch

    from corda_tpu_torch.crypto import ed25519_host as host
    from corda_tpu_torch.ops.ed25519_sign import (
        comb_plain,
        comb_table,
        ed25519_comb,
        ed25519_sign_batch,
    )

    L = host.L
    rs = [0, 1, L - 1, 2**252, 2**256 - 1]
    rs += [j * 16**k for k in range(64) for j in (1 + k % 15, 15)]
    # digits in one quad's 16 windows only (each quad in turn)
    rs += [v << (64 * q) for q in range(4) for v in (2**64 - 1, 1, rng.randrange(2**64))]
    rs += [rng.randrange(L) for _ in range(n - len(rs))]
    raw = np.frombuffer(b"".join(r.to_bytes(32, "little") for r in rs), np.uint8)
    r_dev = torch.from_numpy(raw.reshape(n, 32).copy()).to(dev)
    table = comb_table(dev)
    got = ed25519_comb(r_dev, table)
    want = comb_plain(r_dev, table)
    if not torch.equal(got, want):
        raise AssertionError("kernel E != plain")
    enc = [bytes(row) for row in got.cpu().numpy()]
    oracle = [host.compress(host.scalar_mul(r % L, host.BASE)) for r in rs]
    if enc != oracle:
        bad = [i for i, (a, b) in enumerate(zip(enc, oracle)) if a != b]
        raise AssertionError(f"kernel E != the oracle at lanes {bad[:20]}")
    err = int((got.int() - want.int()).abs().max())
    print(f"kernel E == plain == oracle: {n} lanes (0, 1, L-1, 2^252, 2^256-1, 16^k*j for "
          f"every window k, digits in one quad's windows only)")
    seeds = [hashlib.sha256(b"signer %d" % (i % 7)).digest() for i in range(SIGN_SAMPLE)]
    msgs = [rng.randbytes(rng.randrange(0, 200)) for _ in range(SIGN_SAMPLE)]
    if ed25519_sign_batch(seeds, msgs, device=dev) != [host.sign(k, m) for k, m in zip(seeds, msgs)]:
        raise AssertionError("ed25519_sign_batch on the card != the oracle's signer")
    print(f"ed25519_sign_batch on the card == ed25519_host.sign: {SIGN_SAMPLE} signatures")
    return err


def timed(fn, acc: list):
    """``fn`` with its host-clock seconds appended to ``acc`` per call."""
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            acc.append(time.perf_counter() - t0)
    return wrapper


def notary_pass(dev, stream, windows, *, sync, host_times=None, validating=False,
                tier=None, provider=None):
    """One pass of the notary over ``windows`` of the stream, from
    ``provider`` (a fresh SQLite one by default) with every id cache cold:
    (results per window, seconds). A validating notary resolves inputs over
    the stream's issue."""
    from corda_tpu_torch.notary import BatchedNotaryService, PersistentUniquenessProvider
    from corda_tpu_torch.testing import state_resolver

    for w in windows:
        for stx in w:
            stx.tx.__dict__.pop("_id", None)
    svc = BatchedNotaryService(
        stream.notary, stream.notary_keypair, provider or PersistentUniquenessProvider(),
        validating=validating, use_scheduler=True, max_batch=len(windows[0]), device=dev,
        tier=tier)
    if host_times is not None:
        svc.dispatch_ids = timed(svc.dispatch_ids, host_times["ids"])
        svc.uniqueness.commit_batch_async = timed(svc.uniqueness.commit_batch_async,
                                                  host_times["commit"])
        svc._dispatch_sign = timed(svc._dispatch_sign, host_times["sign"])
        if "validate" in host_times:
            svc.validate = timed(svc.validate, host_times["validate"])
    resolve = state_resolver(stream.issue.tx) if validating else None
    requests = [[(stx, resolve, "alice") for stx in w] for w in windows]
    sync()
    t0 = time.perf_counter()
    out = svc.process_stream(requests, depth=NOTARY_DEPTH)
    sync()
    return out, time.perf_counter() - t0


def check_notary_results(out, stream, dev, oracle: bool, validating: bool = True) -> int:
    """Every request came back as its expected kind (a non-validating
    notary signs the contract-invalid ones); every signature verifies
    through the port's verify path, and (``oracle``) a sample through the
    oracle over ids the host recomputes. Returns the signed count."""
    from corda_tpu_torch.crypto import ed25519_host as host
    from corda_tpu_torch.serialization import deserialize
    from corda_tpu_torch.testing import outcome_kind
    from corda_tpu_torch.verifier import verify_signature_rows

    got = [[outcome_kind(r) for r in w] for w in out]
    kinds = stream.kinds if validating else stream.kinds_nonvalidating
    if got != kinds:
        bad = [(wi, si, g, k) for wi, (gw, kw) in enumerate(zip(got, kinds))
               for si, (g, k) in enumerate(zip(gw, kw)) if g != k]
        raise AssertionError(f"notary outcomes differ (window, slot, got, want): {bad[:10]}")
    flat = [(stx, r) for w_out, w_in in zip(out, stream.windows)
            for stx, r in zip(w_in, w_out) if outcome_kind(r) == "signed"]
    rows = [(r.by, r.signature, r.signable_for(stx.id)) for stx, r in flat]
    if not verify_signature_rows(rows, device=dev).all():
        raise AssertionError("a notary signature fails the port's verify path")
    for stx, r in [] if not oracle else flat[:: max(1, len(flat) // ORACLE_SAMPLE)][:ORACLE_SAMPLE]:
        tx_id = deserialize(stx.tx_bits).id  # recomputed on the host
        if tx_id != stx.id or not host.verify(r.by.encoded, r.signature, r.signable_for(tx_id)):
            raise AssertionError(f"notary signature on {tx_id} fails the oracle")
    return len(flat)


def notary_phase(dev, rng, card, int_rate, n_moves=NOTARY_TXS, window=NOTARY_WINDOW):
    """Phase 8: the notary stream through process_stream, its checks and
    numbers, and kernels C, D and E held against their plain versions and
    timed at one window's shapes, D also on the deep cohort. Returns the
    launch counts of the first pass and (ms, plain ms, bound, largest
    difference from the plain version) per new kernel."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from corda_tpu_torch.crypto import (
        CURRENT_PLATFORM_VERSION,
        EDDSA_ED25519_SHA512,
        SignableData,
        SignatureMetadata,
        ed25519_host,
    )
    from corda_tpu_torch.ledger import ComponentGroupType
    from corda_tpu_torch.ops import _build, txid
    from corda_tpu_torch.ops.ed25519_ladder import ed25519_verify_ladder
    from corda_tpu_torch.ops.ed25519_sign import (
        COMB_ROWS,
        comb_plain,
        comb_table,
        ed25519_comb,
        ed25519_sign_dispatch,
    )
    from corda_tpu_torch.ops.scalar25519 import ed25519_challenge
    from corda_tpu_torch.ops.opcount import (
        INT_OPS_PER_BLOCK,
        INT_OPS_PER_PAIR,
        INT_OPS_ROUNDS_PER_BLOCK,
        comb_int_ops,
    )
    from corda_tpu_torch.ops.sha256 import (
        digest_words_to_bytes,
        pack_messages,
        sha256_leaves,
        sha256_leaves_plain,
        sha256_merkle_sweep,
        sha256_sweep_plain,
    )
    from corda_tpu_torch.serving import shutdown_scheduler
    from corda_tpu_torch.testing import ADVERSARIAL_KINDS, notary_stream

    t0 = time.perf_counter()
    # one stream for phases 8, 13, 19 and 20: the contract-invalid kinds
    # ride in it, which a non-validating notary signs
    stream = notary_stream(n_moves, window, seed=20261017, contract_invalid=True, device=dev)
    stxs = [stx for w in stream.windows for stx in w]
    # the notary holds each request's serialized component rows (as
    # bench.py's stream does); the ids stay cold for every pass
    for stx in stxs:
        for g in ComponentGroupType:
            stx.tx.component_bytes(g)
    print(f"notary stream: {len(stxs)} requests ({n_moves} moves and "
          f"{len(stxs) - n_moves} adversarial) in {len(stream.windows)} windows of "
          f"{window}, built and signed on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    try:
        notary_pass(dev, stream, stream.windows[:2], sync=sync)  # warm-up
        kernels_ae = (ed25519_challenge, ed25519_verify_ladder, sha256_leaves,
                      sha256_merkle_sweep, ed25519_comb)
        # the first pass counts its id sweeps beside the kernels' launches
        sweeps = [0]
        roots_device = txid._tx_id_roots_device

        def counted_sweep(*args):
            sweeps[0] += 1
            return roots_device(*args)

        for k in kernels_ae:
            k.launches = 0
        txid._tx_id_roots_device = counted_sweep
        try:
            out, first_s = notary_pass(dev, stream, stream.windows, sync=sync)
        finally:
            txid._tx_id_roots_device = roots_device
        launches_n = {k.__name__: k.launches for k in kernels_ae}
        host_times = {"ids": [], "commit": [], "sign": []}
        steady, steady_s = notary_pass(dev, stream, stream.windows, sync=sync,
                                       host_times=host_times)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_n:
            profiled_n, prof_n_s = notary_pass(dev, stream, stream.windows, sync=sync)
    finally:
        shutdown_scheduler()
    for k, res in enumerate((out, steady, profiled_n)):
        n_signed = check_notary_results(res, stream, dev, oracle=k == 0, validating=False)
    if min(launches_n.values()) == 0:
        raise AssertionError(f"notary path launches {launches_n}: it missed a kernel")
    if launches_n["sha256_merkle_sweep"] != sweeps[0]:
        raise AssertionError(f"kernel D launched {launches_n['sha256_merkle_sweep']} times for "
                             f"{sweeps[0]} id sweeps: want one launch a sweep")
    print(f"notary path, first pass: kernel D launched {launches_n['sha256_merkle_sweep']} times "
          f"for {sweeps[0]} id sweeps")
    print(f"notary path: every request as expected ({n_signed} signed; "
          f"{len(stxs) - n_signed} rejected, one of each adversarial kind "
          f"{[name for name, _kind in ADVERSARIAL_KINDS]}), every signature verified "
          f"on the card and {ORACLE_SAMPLE} by the oracle; launches {launches_n}")
    print(f"notary, first pass: {n_signed} notarised in {first_s * 1e3:.1f} ms (host clock) = "
          f"{n_signed / first_s:.0f} tx/s  [{card}]")
    print(f"notary, steady pass: {n_signed} notarised in {steady_s * 1e3:.1f} ms = "
          f"{n_signed / steady_s:.0f} tx/s  [{card}]")
    busy_ms, device_us = device_busy(prof_n)
    print(f"notary, profiled pass: {prof_n_s * 1e3:.1f} ms host clock, device busy "
          f"{busy_ms:.1f} ms = {busy_ms / (prof_n_s * 1e3):.1%}; by name: "
          + ", ".join(f"{k.split('(')[0]} {v / 1e3:.2f} ms"
                      for k, v in sorted(device_us.items(), key=lambda kv: -kv[1])[:8])
          + f"  [{card}]")

    # the signing's host half for one full window: the nonces and the
    # enqueue, then (card idle) the responses S = r + h * a
    ids = [stx.id for stx in stream.windows[1]]
    meta = SignatureMetadata(CURRENT_PLATFORM_VERSION, EDDSA_ED25519_SHA512)
    payloads = [SignableData(i, meta).to_bytes() for i in ids]
    seed = stream.notary_keypair.private.encoded
    t0 = time.perf_counter()
    pending_sig = ed25519_sign_dispatch([seed] * len(ids), payloads, device=dev)
    sign_enqueue_ms = (time.perf_counter() - t0) * 1e3
    sync()
    t0 = time.perf_counter()
    pending_sig.collect()
    sign_finish_ms = (time.perf_counter() - t0) * 1e3
    per_window = {k: 1e3 * sum(v) / len(v) for k, v in host_times.items()}
    print(f"notary host time per window of {window} (steady pass, host clock): "
          f"id sweep prep and enqueue {per_window['ids']:.2f} ms, commit "
          f"{per_window['commit']:.2f} ms, signing enqueue {per_window['sign']:.2f} ms; "
          f"signing's host half alone: nonces and enqueue {sign_enqueue_ms:.2f} ms + "
          f"responses {sign_finish_ms:.2f} ms  [{card}]")

    # the id sweep's host half for one window, stage by stage, beside the
    # host computing the same ids with hashlib (host clock)
    window_txs = [stx.tx for stx in stream.windows[1]]
    t0 = time.perf_counter()
    flat = txid._flatten(window_txs)
    t1 = time.perf_counter()
    leaf_msgs, levels, roots, rows = txid._plan(*flat)
    t2 = time.perf_counter()
    pack_messages(leaf_msgs)
    t3 = time.perf_counter()
    for wtx in window_txs:
        wtx.__dict__.pop("_id", None)
    t4 = time.perf_counter()
    for wtx in window_txs:
        wtx.id
    t5 = time.perf_counter()
    print(f"id sweep host half for one window of {window}: flatten "
          f"{(t1 - t0) * 1e3:.2f} ms, plan (nonce hashing, levels) {(t2 - t1) * 1e3:.2f} ms, "
          f"pack {(t3 - t2) * 1e3:.2f} ms; the same ids by hashlib on the host "
          f"{(t5 - t4) * 1e3:.2f} ms  [{card}]")

    # kernels C, D and E against their plain versions at the shapes one
    # window of the path gives them: C over the window's leaves, D over
    # every level of its sweep, E over a window of nonces
    n_leaves = len(leaf_msgs)
    (blocks, offs, cnts), leaf_words, err_c = hold_leaves(
        dev, leaf_msgs, f"the window's {n_leaves} leaves")
    pool = torch.zeros((rows, 8), dtype=torch.int32, device=dev)
    pool[:n_leaves] = leaf_words
    pool_plain = pool.clone()
    plan = txid.upload_levels(levels, dev)
    sha256_merkle_sweep(pool, plan)
    sha256_sweep_plain(pool_plain, plan)
    if not torch.equal(pool, pool_plain):
        raise AssertionError(f"kernel D != plain over the window's {len(levels)} levels")
    if digest_words_to_bytes(pool[roots].cpu().numpy()) != [wtx.id.bytes for wtx in window_txs]:
        raise AssertionError("the window's roots from kernels C and D != the host's ids")
    err_d = int((pool.long() - pool_plain.long()).abs().max())
    r_win = torch.from_numpy(np.frombuffer(b"".join(
        rng.randrange(ed25519_host.L).to_bytes(32, "little") for _ in range(window)),
        np.uint8).reshape(window, 32).copy()).to(dev)
    ctable = comb_table(dev)
    got_e = ed25519_comb(r_win, ctable)
    want_e = comb_plain(r_win, ctable)
    if not torch.equal(got_e, want_e):
        raise AssertionError(f"kernel E != plain at {window} lanes")
    r_host = r_win.cpu().numpy()
    enc = got_e.cpu().numpy()
    oracle_lanes = range(0, window, max(1, window // 128))
    for i in oracle_lanes:
        r = int.from_bytes(r_host[i].tobytes(), "little")
        if enc[i].tobytes() != ed25519_host.compress(ed25519_host.scalar_mul(r, ed25519_host.BASE)):
            raise AssertionError(f"kernel E != the oracle at lane {i} of {window}")
    err_e = int((got_e.int() - want_e.int()).abs().max())
    n_pairs = sum(len(lv[1]) for lv in levels)
    print(f"at one window's shapes: kernel C == plain == hashlib over {n_leaves} leaves "
          f"({int(cnts.sum())} blocks); kernel D == plain over {len(levels)} levels "
          f"({n_pairs} pairs: {[len(lv[1]) for lv in levels]}) in one launch, roots == host ids; "
          f"kernel E == plain over {window} lanes ({len(oracle_lanes)} of them == oracle)")
    # kernel C on 13-block leaves alone: as many as a window holds, and one
    # warp of them (its serial floor measured directly)
    long_leaves = {}
    for lanes in C_LONG_LANES:
        msgs = [rng.randbytes(C_LONG_BYTES) for _ in range(lanes)]
        long_leaves[lanes], _w, err = hold_leaves(dev, msgs, f"{lanes} leaves of 13 blocks")
        err_c = max(err_c, err)
    print(f"kernel C == plain == hashlib at {' and '.join(map(str, C_LONG_LANES))} leaves of "
          f"{C_LONG_BYTES} bytes (13 blocks each)")
    err_c = max(err_c, deep_cohort_check(dev, [stream.issue.tx] + window_txs[:3]))

    # times on the card (the stream held while the host queues the runs),
    # each beside the host's time a call
    n_blocks = int(cnts.sum())
    ms_c, host_c = device_times(lambda: sha256_leaves(blocks, offs, cnts), 50)
    plain_ms_c = plain_ms(lambda: sha256_leaves_plain(blocks, offs, cnts))
    ms_d, host_d = device_times(lambda: sha256_merkle_sweep(pool, plan), 50)
    plain_ms_d = plain_ms(lambda: sha256_sweep_plain(pool_plain, plan))
    ms_e, host_e = device_times(lambda: ed25519_comb(r_win, ctable), 20)
    plain_ms_e = plain_ms(lambda: comb_plain(r_win, ctable))
    bound_c = bound(n_blocks * 64 + len(leaf_msgs) * (8 + 32),
                    n_blocks * INT_OPS_PER_BLOCK, int_rate)
    bound_d = bound(n_pairs * (64 + 8 + 32), n_pairs * INT_OPS_PER_PAIR, int_rate)
    bound_e = bound(window * 64 + COMB_ROWS * 40,
                    window * comb_int_ops(), int_rate)
    for name, shape, ms, host_ms, p_ms, (b_ms, b_by) in (
        ("sha256_leaves", f"{len(leaf_msgs)} leaves, {n_blocks} blocks", ms_c, host_c,
         plain_ms_c, bound_c),
        ("sha256_merkle_sweep", f"one window's sweep, {len(levels)} levels of {n_pairs} pairs",
         ms_d, host_d, plain_ms_d, bound_d),
        ("ed25519_comb", f"{window} lanes", ms_e, host_e, plain_ms_e, bound_e),
    ):
        print(f"{name}: {ms:.4f} ms on the card at {shape}, host {host_ms:.4f} ms a call "
              f"(plain {p_ms:.1f} ms, bound {b_ms:.4f} ms by {b_by}, {b_ms / ms:.1%} of it)"
              f"  [{card}]")
    # kernel C's serial floor: the longest message's rounds on the consumer
    # warp (the producer's schedule on another scheduler), against the card
    # at the window, at a window's count of 13-block leaves and at one warp
    mhz = card_rates()[1]
    for label, (bl, of, cn) in [(f"the window's {n_leaves} leaves", (blocks, offs, cnts))] + [
            (f"{lanes} leaves of 13 blocks", long_leaves[lanes]) for lanes in C_LONG_LANES]:
        longest = int(cn.max())
        ms, host_ms = device_times(lambda: sha256_leaves(bl, of, cn), 50)
        floor = serial_floor_ms(longest * INT_OPS_ROUNDS_PER_BLOCK, mhz)
        one_thread = serial_floor_ms(longest * INT_OPS_PER_BLOCK, mhz)
        b_ms, b_by = bound(int(cn.sum()) * 64 + cn.numel() * (8 + 32),
                           int(cn.sum()) * INT_OPS_PER_BLOCK, int_rate)
        print(f"sha256_leaves at {label}: {ms:.4f} ms on the card, host {host_ms:.4f} ms a "
              f"call; serial floor {floor:.4f} ms ({longest} blocks x {INT_OPS_ROUNDS_PER_BLOCK} "
              f"operations on the consumer warp at {mhz:g} MHz; one thread a message: "
              f"{one_thread:.4f}), {floor / ms:.1%} of it; bound {b_ms:.4f} ms by {b_by}, "
              f"{b_ms / ms:.1%} of it  [{card}]")
    # kernel E's inversion alone in E's launch shape, and E's and D's
    # compiler report
    if dev.type == "cuda":
        lib = _build.kernels()
        words = torch.empty((4 * window,), dtype=torch.int32, device=dev)
        chain = cuda_ms(lambda: _build.check_launch(lib.ct_comb_chain_probe(
            r_win.data_ptr(), words.data_ptr(), window, _build.stream_of(r_win)),
            "comb_chain_probe"), 20)
        print(f"kernel E's inversion alone (E's launch shape): {chain:.4f} ms at {window} "
              f"lanes = {chain / ms_e:.1%} of E  [{card}]")
    print_ptxas("kernels C, D, E", ("sha256_leaves", "sha256_merkle_sweep", "ed25519_comb"))

    return {
        "launches": launches_n,
        "stream": stream,
        "sha256_leaves": (ms_c, plain_ms_c, bound_c, err_c),
        "sha256_merkle_sweep": (ms_d, plain_ms_d, bound_d, err_d),
        "ed25519_comb": (ms_e, plain_ms_e, bound_e, err_e),
    }


def deep_cohort_check(dev, wtxs) -> int:
    """Kernels C and D on a cohort whose first transaction has a group of
    thousands of components (the stream's issue: a group tree far deeper
    than the top tree): C over its leaves against its plain version and
    hashlib, D's sweep in one launch against its plain version, and
    ``compute_tx_ids`` on the card against the host's ids. Returns C's
    largest difference from its plain version (0)."""
    import torch

    from corda_tpu_torch.ops import txid
    from corda_tpu_torch.ops.sha256 import (
        digest_words_to_bytes,
        sha256_merkle_sweep,
        sha256_sweep_plain,
    )

    flat = txid._flatten(wtxs)
    leaf_msgs, levels, roots, rows = txid._plan(*flat)
    pool = torch.zeros((rows, 8), dtype=torch.int32, device=dev)
    _up, leaf_words, err_c = hold_leaves(dev, leaf_msgs, "the deep cohort's leaves")
    pool[: len(leaf_msgs)] = leaf_words
    pool_plain = pool.clone()
    plan = txid.upload_levels(levels, dev)
    sha256_merkle_sweep(pool, plan)
    sha256_sweep_plain(pool_plain, plan)
    want = [wtx.id.bytes for wtx in wtxs]  # the host's hashlib ids
    if not torch.equal(pool, pool_plain):
        raise AssertionError("kernel D != plain on the deep cohort")
    if digest_words_to_bytes(pool[roots].cpu().numpy()) != want or \
            [i.bytes for i in txid.compute_tx_ids(wtxs, device=dev)] != want:
        raise AssertionError("the deep cohort's ids on the card != the host's")
    widest = max(hi - lo for lo, hi in flat[2][0])
    print(f"deep cohort: kernel C == plain == hashlib over its {len(leaf_msgs)} leaves, kernel "
          f"D == plain over {len(levels)} levels in one launch (the first transaction's "
          f"largest group {widest} components), compute_tx_ids on the card == host ids for "
          f"{len(wtxs)} transactions")
    return err_c


def check_ecdsa_kernel(dev, curve, card, int_rate, n=ECDSA_LANES,
                       sizes=(512, ECDSA_SHARE, 8192)):
    """Phase 9 for one curve: kernel F against its plain version on the
    card and the oracle, then its times at ``sizes`` (the last is the full
    bucket, the middle one a curve's share of it). Returns (ms, plain ms,
    bound, largest difference) at the full bucket."""
    import numpy as np
    import torch

    from corda_tpu_torch.crypto import ecdsa_host
    from corda_tpu_torch.ops.secp256 import _prep_byte_planes, pack_planes
    from corda_tpu_torch.ops.opcount import ecdsa_int_ops
    from corda_tpu_torch.ops.secp256_ladder import (
        ECDSA_ROW,
        VERIFY,
        ecdsa_table,
        verify_plain,
    )
    from corda_tpu_torch.testing import ecdsa_adversarial_lanes, mixed_rows

    t0 = time.perf_counter()
    lanes = ecdsa_adversarial_lanes(curve, seed=9)
    kinds = [k for k, *_ in lanes]
    pool = [(pk, sig, msg) for _k, pk, sig, msg in lanes]
    pool += [(k.encoded, s, m) for k, s, m in
             mixed_rows(((curve, n - len(pool)),), seed=9, device="cpu")]
    cv = ecdsa_host.CURVES[curve]
    sample = list(range(len(lanes))) + list(range(len(lanes), n, max(1, n // (512 - len(lanes)))))
    sample = sample[:512]
    oracle = {i: ecdsa_host.verify(cv, *pool[i]) for i in sample}
    print(f"{curve}: signed {n - len(lanes)} rows and checked {len(sample)} with the "
          f"oracle in {time.perf_counter() - t0:.1f} s ({len(kinds)} kinds: {', '.join(kinds)})")

    def packed_for(triples, b):
        pks, sigs, msgs = map(list, zip(*triples))
        host = np.zeros((b, ECDSA_ROW), np.uint8)
        pack_planes(host, _prep_byte_planes(curve, pks, sigs, msgs, b))
        return torch.from_numpy(host).to(dev)

    verify = VERIFY[curve]
    table = ecdsa_table(curve, dev)
    packed = packed_for(pool, n)
    got = verify(packed, table)
    want = verify_plain(curve, packed, table)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = torch.nonzero(got != want).flatten().tolist()
        raise AssertionError(f"{verify.__name__} != plain at lanes {bad[:20]}")
    host = got.cpu().numpy()
    bad = [i for i in sample if bool(host[i]) != oracle[i]]
    if bad:
        raise AssertionError(f"{verify.__name__} != the oracle at lanes {bad[:20]}")
    err = int((got.int() - want.int()).abs().max())
    accepted = dict(zip(kinds, host[: len(kinds)].tolist()))
    print(f"{verify.__name__} == plain: {n} lanes ({int(got.sum())} accepted), == oracle on "
          f"{len(sample)}; the kinds accepted: {[k for k, v in accepted.items() if v]}")

    # times: lanes of valid rows (tiled), then the main path's shape, a
    # curve's share of an 8,192-row batch padded to 8,192 lanes
    valid = [t for i, t in enumerate(pool) if host[i]]
    ops = ecdsa_int_ops(curve)
    table_bytes = table.numel() * 4
    share, full = sizes[1], sizes[-1]
    times = {}
    for b in sizes:
        pk_b = packed_for([valid[i % len(valid)] for i in range(b)], b)
        times[b] = cuda_ms(lambda: verify(pk_b, table), 10 if b < full else 5)
    path = packed_for([valid[i % len(valid)] for i in range(share)], full)
    got_path = verify(path, table)
    want_path = verify_plain(curve, path, table)
    torch.cuda.synchronize()
    if not torch.equal(got_path, want_path) or int(got_path.sum()) != share:
        raise AssertionError(f"{verify.__name__} != plain at the path's shape")
    err = max(err, int((got_path.int() - want_path.int()).abs().max()))
    # the path's shape again with every adversarial kind among its rows
    adv_path = packed_for([pool[i % n] for i in range(share)], full)
    got_adv = verify(adv_path, table)
    want_adv = verify_plain(curve, adv_path, table)
    torch.cuda.synchronize()
    host_adv = got_adv.cpu().numpy()
    if not torch.equal(got_adv, want_adv) or any(
            bool(host_adv[i]) != oracle[i] for i in sample if i < share) or \
            host_adv[share:].any():
        raise AssertionError(f"{verify.__name__} != plain or the oracle at the path's shape "
                             "with the adversarial kinds")
    print(f"{verify.__name__} == plain at the path's shape with every adversarial kind "
          f"({int(got_adv.sum())} of {share} accepted), == oracle on "
          f"{sum(i < share for i in sample)}")
    path_ms = cuda_ms(lambda: verify(path, table), 10)
    big = packed_for([valid[i % len(valid)] for i in range(full)], full)
    plain_t = plain_ms(lambda: verify_plain(curve, big, table))
    for b, ms in times.items():
        b_ms, b_by = bound(b * (ECDSA_ROW + 1) + table_bytes, b * ops, int_rate)
        print(f"{verify.__name__}: {ms:.4f} ms at B={b} ({b / ms * 1e3:.0f} sigs/s; bound "
              f"{b_ms:.4f} ms by {b_by}, {b_ms / ms:.1%} of it)  [{card}]")
    p_ms, p_by = bound(full * (ECDSA_ROW + 1) + table_bytes, share * ops, int_rate)
    print(f"{verify.__name__}: {path_ms:.4f} ms at the path's shape ({share} signatures "
          f"padded to {full} lanes; bound {p_ms:.4f} ms by {p_by}); plain {plain_t:.1f} ms at "
          f"B={full}; {ops} integer operations a lane  [{card}]")
    return (times[full], plain_t,
            bound(full * (ECDSA_ROW + 1) + table_bytes, full * ops, int_rate), err)


# phase 10's distinct rows and their oracle verdicts, for phase 26a
MIXED_DISTINCT: dict = {}


def mixed_phase(dev, card, sizes=MIXED_SIZES, tile=MIXED_TILE, composition=None,
                full=8192):
    """Phase 10: the mixed backlog through the scheduler, its checks and
    numbers. Returns the launch counts of the first pass."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from corda_tpu_torch.crypto import PublicKey, is_valid
    from corda_tpu_torch.ops.ed25519_ladder import ed25519_verify_ladder
    from corda_tpu_torch.ops.scalar25519 import ed25519_challenge
    from corda_tpu_torch.ops.secp256 import _prep_byte_planes
    from corda_tpu_torch.ops.secp256_ladder import ecdsa_verify_k1, ecdsa_verify_r1
    from corda_tpu_torch.ops.sphincs_batch import ROW_BYTES, pack_plane, pad_floor, \
        pow2_at_least, sphincs_verify
    from corda_tpu_torch.serving import BULK, INTERACTIVE, SERVICE, DeviceScheduler
    from corda_tpu_torch.testing import (
        MIXED_COMPOSITION,
        ecdsa_adversarial_lanes,
        mixed_rows,
        rsa_adversarial_lanes,
        sphincs_adversarial_lanes,
    )
    from corda_tpu_torch.verifier import dispatch_signature_rows

    composition = composition or MIXED_COMPOSITION
    t0 = time.perf_counter()
    timings = {}
    rows = mixed_rows(composition, keys_per_scheme=16, tile=tile, seed=10, device=dev,
                      timings=timings)
    adversarial = [(PublicKey(sid, pk), s, m) for sid, curve in ((2, "secp256k1"), (3, "secp256r1"))
                   for _k, pk, s, m in ecdsa_adversarial_lanes(curve, seed=10)]
    adversarial += [(PublicKey(5, pk), s, m) for _k, pk, s, m in sphincs_adversarial_lanes(10)]
    adversarial += [(PublicKey(1, pk), s, m) for _k, pk, s, m in rsa_adversarial_lanes(10)]
    positions = [(7 + 733 * k) % len(rows) for k in range(len(adversarial))]
    for pos, row in zip(positions, adversarial):
        rows[pos] = row
    distinct = {}
    for row in rows:
        if row not in distinct:
            distinct[row] = is_valid(*row)
    want = [distinct[row] for row in rows]
    MIXED_DISTINCT.update(distinct)  # phase 26a's mixed batch
    n_rows = len(rows)
    n_host = sum(key.scheme_id == 1 for key, _s, _m in rows)
    assert sum(sizes) == n_rows, (sum(sizes), n_rows)
    print(f"mixed backlog: {n_rows} rows ({', '.join(f'{c} {name}' for name, c in composition)}"
          f" x {tile}, bench.py's whole MIXED_COMPOSITION), {len(adversarial)} adversarial "
          f"ECDSA, SPHINCS and RSA lanes at known positions, {n_host} RSA rows (host rows), "
          f"{len(distinct)} distinct rows checked by the oracle ({sum(distinct.values())} valid),"
          f" built in {time.perf_counter() - t0:.1f} s (by scheme: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in timings.items()) + ")")

    rows_by_req, requests, at = [], [], 0
    for k, size in enumerate(sizes):
        rows_by_req.append(rows[at : at + size])
        requests.append((rows[at : at + size], want[at : at + size],
                         (BULK, SERVICE, INTERACTIVE)[k % 3]))
        at += size
    classes = [cls for _r, _w, cls in requests]
    kernels = (ed25519_challenge, ed25519_verify_ladder, ecdsa_verify_k1, ecdsa_verify_r1,
               sphincs_verify)
    # the three-scheme cut, the same rows less the SPHINCS and RSA ones,
    # served twice by the same scheduler for a rate in the same call
    cut_requests = [([r for r in req if r[0].scheme_id in (2, 3, 4)], cls)
                    for req, cls in zip(rows_by_req, classes)]
    cut_requests = [(req, [distinct[r] for r in req], cls) for req, cls in cut_requests if req]
    cut = [req for req, _w, _c in cut_requests]
    n_cut = sum(map(len, cut))
    sched = DeviceScheduler(device=dev)
    try:
        sched.submit_rows(rows_by_req[-3]).result(timeout=300)  # warm-up
        before = dict(sched.counters)
        for k in kernels:
            k.launches = 0
        results, e2e_ms, wall_ms = serve_backlog(sched, rows_by_req, classes)
        launches = {k.__name__: k.launches for k in kernels}
        counters = {k: v - before[k] for k, v in sched.counters.items()}
        steady, steady_ms, _ = serve_backlog(sched, rows_by_req, classes)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled, _, prof_wall_ms = serve_backlog(sched, rows_by_req, classes)
        cut_passes = [serve_backlog(sched, cut, [c for _r, _w, c in cut_requests])
                      for _ in range(2)]
        steady2, steady2_ms, _ = serve_backlog(sched, rows_by_req, classes)
    finally:
        sched.shutdown()
    for res in (results, steady, profiled, steady2):
        check_backlog(res, requests, n_rows, n_rows - n_host)
    for res, _ms, _wall in cut_passes:
        check_backlog(res, cut_requests, n_cut)
    if min(launches.values()) == 0:
        raise AssertionError(f"mixed path launches {launches}: it missed a kernel")
    batches = sorted({rr.batch_seq for rr in results.values()})
    dev_rows, lanes = counters["serving.device_rows"], counters["serving.padded_lanes"]
    if dev_rows != n_rows - n_host:
        raise AssertionError(f"mixed path sent {dev_rows} of {n_rows} rows to the device, "
                             f"expected all but the {n_host} RSA rows")
    print(f"mixed path: {len(requests)} requests, {n_rows} signatures, {len(batches)} device "
          f"batches, every verdict == oracle, device_rows == {dev_rows} (all but the {n_host} "
          f"RSA rows); launches {launches}; padded lanes {lanes} for {dev_rows} rows "
          f"({1 - dev_rows / lanes:.1%} padding); counters {counters}")
    print(f"mixed e2e, first pass: {n_rows} sigs in {e2e_ms:.1f} ms (CUDA events; host clock "
          f"{wall_ms:.1f} ms) = {n_rows / e2e_ms * 1e3:.0f} sigs/s  [{card}]")
    print(f"mixed e2e, steady passes: {n_rows} sigs in {steady_ms:.1f} and {steady2_ms:.1f} ms "
          f"(CUDA events) = {n_rows / steady_ms * 1e3:.0f} and "
          f"{n_rows / steady2_ms * 1e3:.0f} sigs/s  [{card}]")
    print(f"mixed e2e, the three-scheme cut (the same rows less SPHINCS and RSA, {n_cut} "
          f"sigs), two passes in the same scheduler after the full ones, every verdict == "
          f"oracle: " + " and ".join(f"{n_cut / ms * 1e3:.0f}" for _r, ms, _w in cut_passes)
          + f" sigs/s  [{card}]")
    busy_ms, device_us = device_busy(prof)
    print(f"mixed, profiled pass: {prof_wall_ms:.1f} ms host clock, device busy {busy_ms:.1f} ms"
          f" = {busy_ms / prof_wall_ms:.1%}; by name: "
          + ", ".join(f"{k.split('(')[0]} {v / 1e3:.2f} ms"
                      for k, v in sorted(device_us.items(), key=lambda kv: -kv[1])[:8])
          + "; kernel H: " + ", ".join(f"{k.split('(')[0]} {v / 1e3:.3f} ms"
                                       for k, v in device_us.items() if "sphincs" in k)
          + f"  [{card}]")

    # the host's share of one 8,192-row mixed batch on the dispatching
    # thread (host clock): prep and enqueue of its buckets, the ECDSA prep,
    # the SPHINCS prep and the RSA bucket (settled on the host)
    batch = rows[:full]
    by_curve = {c: [r for r in batch if r[0].scheme_id == sid]
                for sid, c in ((2, "secp256k1"), (3, "secp256r1"))}
    sph = [r for r in batch if r[0].scheme_id == 5]
    rsa_rows = [r for r in batch if r[0].scheme_id == 1]
    b_sph = pow2_at_least(max(len(sph), 1), pad_floor(full))
    prep_ms, ecdsa_ms, sph_ms, rsa_ms = [], [], [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = dispatch_signature_rows(batch, min_bucket=full, device=dev)
        prep_ms.append((time.perf_counter() - t0) * 1e3)
        pending.collect()
        t0 = time.perf_counter()
        for curve, crow in by_curve.items():
            _prep_byte_planes(curve, [k.encoded for k, _s, _m in crow],
                              [s for _k, s, _m in crow], [m for _k, _s, m in crow], full)
        ecdsa_ms.append((time.perf_counter() - t0) * 1e3)
        plane = np.zeros(b_sph * ROW_BYTES, np.uint8)
        t0 = time.perf_counter()
        pack_plane(plane, [k.encoded for k, _s, _m in sph], [s for _k, s, _m in sph],
                   [m for _k, _s, m in sph])
        sph_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        for row in rsa_rows:
            is_valid(*row)
        rsa_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"one {full}-row mixed batch ({', '.join(f'{len(v)} {c}' for c, v in by_curve.items())},"
          f" {len(sph)} SPHINCS in a {b_sph}-lane bucket, {len(rsa_rows)} RSA): host prep + "
          f"enqueue {sorted(prep_ms)[2]:.2f} ms (median of 5), of which the two ECDSA buckets' "
          f"_prep_byte_planes {sorted(ecdsa_ms)[2]:.2f} ms, the SPHINCS prep (pack_plane) "
          f"{sorted(sph_ms)[2]:.2f} ms, the RSA bucket (host verify) {sorted(rsa_ms)[2]:.2f} ms"
          f"  [{card}]")
    return launches


def check_sphincs_kernel(dev, card, int_rate, mhz, sizes=H_SIZES):
    """Phase 16: kernel H against its plain version and the host engine,
    its times beside its bound, serial floor, plain version and the host
    route, and ptxas' report. Returns {lanes: (ms, plain ms, bound,
    largest difference)}."""
    import numpy as np
    import torch

    from corda_tpu_torch.crypto import derive_keypair_from_entropy, sign, sphincs
    from corda_tpu_torch.ops import _build
    from corda_tpu_torch.ops.opcount import (
        INT_OPS_PER_BLOCK,
        sphincs_chain_ops,
        sphincs_lane_work,
    )
    from corda_tpu_torch.ops.sphincs_batch import (
        ROW_BYTES,
        pack_plane,
        split_plane,
        sphincs_stages_plain,
        sphincs_verify,
        sphincs_verify_plain,
    )
    from corda_tpu_torch.testing import sphincs_adversarial_lanes

    print_ptxas("kernel H", ("sphincs_verify",))
    print(f"kernel H: {_build.kernels().ct_sphincs_smem_bytes()} bytes of static shared memory "
          "a block (one lane, 96 threads: the warp pair and the hoister)")
    t0 = time.perf_counter()
    lanes = sphincs_adversarial_lanes(16)
    kinds = [k for k, *_ in lanes]
    valid = []
    for k in range(4):
        kp = derive_keypair_from_entropy(5, hashlib.sha256(b"phase 16 %d" % k).digest())
        msg = b"phase 16 message %d" % k
        valid.append((kp.public.encoded, sign(kp.private, msg), msg))
    pool = [t[1:] for t in lanes] + valid
    oracle = [sphincs.verify(*t) for t in pool]
    print(f"kernel H lanes: {len(kinds)} adversarial kinds ({', '.join(kinds)}) and "
          f"{len(valid)} more valid signatures, signed and checked by the host engine in "
          f"{time.perf_counter() - t0:.1f} s")

    def planes(triples, device=dev):
        plane = np.zeros(len(triples) * ROW_BYTES, np.uint8)
        pack_plane(plane, *map(list, zip(*triples)))
        return split_plane(torch.from_numpy(plane).to(device))

    # each valid lane's work, from the digests its layers sign (the plain
    # version's stages, on the host): its blocks, the parent design's chain
    # of blocks and the redesigned chain's operations
    valid_planes = planes(valid, "cpu")
    stages = sphincs_stages_plain(*valid_planes[:3])
    signed_of = [[bytes(s[i].numpy()) for s in stages[:-1]] for i in range(len(valid))]
    work_of = [sphincs_lane_work(signed) + (sphincs_chain_ops(signed, int(idx)),)
               for signed, idx in zip(signed_of, valid_planes[2].tolist())]

    # the plain version on the adversarial lanes at the mixed path's
    # bucket (32) and at the largest size up to H_PLAIN_MAX: it runs every
    # step of every lane whatever the data, and lane i's inputs are the same
    # at every size, so each size up to there is held against the first n
    # lanes of the smallest run that covers it, and those runs give the
    # plain version's time; every size is held against the host engine
    err, plain_at, plain_out = 0, {}, {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    plain_sizes = {H_MIXED_BUCKET, max(n for n in sizes if n <= H_PLAIN_MAX)}
    for n in sorted(plain_sizes, reverse=True):  # 32 runs warm
        views = planes([pool[i % len(pool)] for i in range(n)])
        start.record()
        plain_out[n] = sphincs_verify_plain(*views)
        end.record()
        end.synchronize()
        plain_at[n] = start.elapsed_time(end)
    for n in sizes:
        trip = [pool[i % len(pool)] for i in range(n)]
        got = sphincs_verify(*planes(trip))
        held = n <= H_PLAIN_MAX
        if held:
            want = plain_out[min(m for m in plain_out if m >= n)][:n]
            if not torch.equal(got, want):
                bad = torch.nonzero(got != want).flatten().tolist()
                raise AssertionError(f"kernel H != plain at {n} lanes, lanes {bad[:20]}")
            err = max(err, int((got.int() - want.int()).abs().max()))
        if got.cpu().tolist() != [oracle[i % len(pool)] for i in range(n)]:
            raise AssertionError(f"kernel H != the host engine at {n} lanes")
        print(f"kernel H == {'plain == ' if held else ''}sphincs.verify: {n} lanes "
              f"({int(got.sum())} accepted; {min(n, len(kinds))} of the {len(kinds)} kinds "
              "among them)")

    out = {}
    for n in sizes:
        trip = [valid[i % len(valid)] for i in range(n)]
        views = planes(trip)
        ms, host_ms = device_times(lambda: sphincs_verify(*views), 20 if n < 1024 else 5)
        t0 = time.perf_counter()
        route = [sphincs.verify(*t) for t in trip]
        route_ms = (time.perf_counter() - t0) * 1e3
        assert all(route)
        work = [work_of[i % len(valid)] for i in range(n)]
        blocks = sum(w[0] for w in work)
        chain = max(w[1] for w in work)
        chain_ops = max(w[2] for w in work)
        b_ms, b_by = bound(n * (ROW_BYTES + 1), blocks * INT_OPS_PER_BLOCK, int_rate)
        floor_ms = serial_floor_ms(chain_ops, mhz)
        old_floor_ms = serial_floor_ms(chain * INT_OPS_PER_BLOCK, mhz)
        out[n] = (ms, plain_at.get(n), (b_ms, b_by), err)
        print(f"sphincs_verify: {ms:.4f} ms on the card at B={n} (host {host_ms:.4f} ms a "
              f"call; {n / ms * 1e3:.0f} sigs/s); bound {b_ms:.4f} ms by {b_by} ({blocks} "
              f"SHA-256 blocks, {b_ms / ms:.1%} of it); serial floor {floor_ms:.4f} ms (the "
              f"pair's chain of {chain_ops} operations, {floor_ms / ms:.1%} of it; the one-"
              f"thread design's floor {old_floor_ms:.4f} ms, a chain of {chain} blocks); plain "
              + (f"{plain_at[n]:.1f} ms (one run)" if n in plain_at else "not run at this size")
              + f"; the host route (sphincs.verify a lane) {route_ms:.1f} ms  [{card}]")
    return out


def check_g_kernel(dev, card, int_rate, pool, oracle, sizes=G_SIZES, n=8192):
    """Phase 11: the verify ladders, kernel B and kernel G, each in both
    fixed-base shapes, against their plain versions on the card and the
    oracle over ``pool``, then their times in turns at ``sizes``, and each
    kernel held against its plain version and the oracle again at ``n``
    lanes (the main path's bucket) and at every shape of ``sizes`` (``pool``
    tiled). Returns {wrapper name: (ms, plain ms, bound, largest
    difference)} at ``n`` lanes."""
    import numpy as np
    import torch

    from corda_tpu_torch.ops import _build
    from corda_tpu_torch.ops import ed25519_ladder as b
    from corda_tpu_torch.ops import ed25519_ladder4096 as g
    from corda_tpu_torch.ops.scalar25519 import challenge_windows_plain

    entry = ""
    for line in _build.build_info.get("ptxas", "").splitlines():
        if "Compiling entry" in line:
            entry = line
        if ("ed25519_verify_g" in entry or "ed25519_verify_ladder" in entry) and any(
                w in line for w in ("Compiling entry", "registers", "spill")):
            print("ptxas (kernels B, G):", line.strip())
    packed = torch.from_numpy(pack_triples(pool)).to(dev)
    win = challenge_windows_plain(packed)
    table_b, table_g = b.ladder_table(dev), g.ladder_table(dev)
    # name -> (wrapper, table, plain version, integer operations a lane)
    ladders = {}
    from corda_tpu_torch.ops.opcount import g_int_ops, ladder_int_ops

    for mod, table, plain in ((b, table_b, b.verify_ladder_plain), (g, table_g, g.verify_plain_g)):
        verifiers = b.VERIFY_B if mod is b else g.VERIFY_G
        int_ops = ladder_int_ops if mod is b else g_int_ops
        for fw, verify in verifiers.items():
            ladders[verify.__name__] = (verify, table, functools.partial(plain, fixed_win=fw),
                                        int_ops(fw))
    if dev.type == "cuda":
        lib = _build.kernels()
        print("dynamic shared memory a block (as each launch sets it): kernel B "
              f"{lib.ct_ed25519_verify_ladder_smem_bytes()} bytes, kernel G "
              f"{lib.ct_ed25519_verify_g_smem_bytes()} bytes")
    errs = {}
    for name, (verify, table, plain, _ops) in ladders.items():
        got = verify(packed, win, table)
        want = plain(packed, win, table)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = torch.nonzero(got != want).flatten().tolist()
            raise AssertionError(f"{name} != plain at lanes {bad[:20]}")
        if got.cpu().numpy().tolist() != oracle.tolist():
            raise AssertionError(f"{name} != the pure-Python oracle")
        errs[name] = int((got.int() - want.int()).abs().max())
        print(f"{name} == plain == oracle: {len(pool)} lanes, {int(got.sum())} accepted")

    # times in turns (each ladder, then the same in reverse) at each shape,
    # means of the pairs
    big = packed.repeat(n // len(pool), 1).contiguous()
    win_big = challenge_windows_plain(big)
    shapes = {}
    for lanes in sizes:
        reps = -(-lanes // n)
        shapes[lanes] = (big.repeat(reps, 1)[:lanes].contiguous(),
                         win_big.repeat(1, reps)[:, :lanes].contiguous())
    order = list(ladders) + list(ladders)[::-1]
    times = {}
    for lanes, (packed_l, win_l) in shapes.items():
        acc = {name: [] for name in ladders}
        for name in order:
            fn, table = ladders[name][:2]
            acc[name].append(cuda_ms(lambda: fn(packed_l, win_l, table), 5))
        times[lanes] = {name: sum(v) / len(v) for name, v in acc.items()}

    def bounds(name, lanes):
        table = ladders[name][1]
        return bound(lanes * (161 + 64 * 4 + 1) + table.numel() * 4,
                     lanes * ladders[name][3], int_rate)

    for lanes, by_name in times.items():
        print(f"ladders at B={lanes}: " + "; ".join(
            f"{name} {ms:.4f} ms (bound {bounds(name, lanes)[0]:.4f} ms by "
            f"{bounds(name, lanes)[1]}, {bounds(name, lanes)[0] / ms:.1%} of it)"
            for name, ms in by_name.items()) + f"  [{card}]")
    b_ms = times[n]["ed25519_verify_ladder"]
    if dev.type == "cuda":
        # the two exponent chains alone, whole on every thread of a quad as
        # the ladders run them (the csrc/fe_chain_probe.cu probe)
        lib = _build.kernels()
        words = torch.empty((4 * n,), dtype=torch.int32, device=dev)
        for field, names in ((10, ("ed25519_verify_ladder", "ed25519_verify_ladder_w4")),
                             (8, ("ed25519_verify_g8", "ed25519_verify_g4"))):
            chain = cuda_ms(lambda: _build.check_launch(lib.ct_fe_chain_probe(
                big.data_ptr(), words.data_ptr(), n, field, _build.stream_of(big)),
                "fe_chain_probe"), 10)
            print(f"exponent chains alone ({field}-word field, four threads a signature): "
                  f"{chain:.4f} ms at B={n} = " + ", ".join(
                      f"{chain / times[n][name]:.1%} of {name}" for name in names)
                  + f"  [{card}]")
    # each kernel against its plain version at n lanes (the plain result of
    # its timed run) and at every timed shape (that result tiled), and
    # against the oracle tiled
    oracle_n = torch.from_numpy(np.resize(np.asarray(oracle, dtype=bool), n)).to(dev)
    out = {}
    for name, (fn, table, plain, ops) in ladders.items():
        plain_out = []
        plain_t = plain_ms(lambda: plain_out.append(plain(big, win_big, table)))
        want_n = plain_out[-1]
        if not torch.equal(want_n.bool(), oracle_n):
            raise AssertionError(f"plain {name} != the pure-Python oracle at {n} lanes")
        for lanes, (packed_l, win_l) in shapes.items():
            got = fn(packed_l, win_l, table)
            want = want_n.repeat(-(-lanes // n))[:lanes]
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = torch.nonzero(got != want).flatten().tolist()
                raise AssertionError(f"{name} != plain at {lanes} lanes, lanes {bad[:20]}")
            errs[name] = max(errs[name], int((got.int() - want.int()).abs().max()))
        print(f"{name} == plain == oracle at " + ", ".join(f"{lanes}" for lanes in shapes)
              + " lanes")
        ms = times[n][name]
        print(f"{name}: {ms:.4f} ms at B={n}, {ms / b_ms:.3f}x kernel B (comb); plain "
              f"{plain_t:.1f} ms; {ops} integer operations a lane  [{card}]")
        out[name] = (ms, plain_t, bounds(name, n), errs[name])
    return out


def tier_backlog_phase(dev, card, rows_by_req, requests, classes, n_rows):
    """Phase 12: phase 4's backlog through a scheduler of the radix-4096
    tier (comb). Returns kernel G's launches in the first pass."""
    from corda_tpu_torch.ops.ed25519 import Ed25519Tier
    from corda_tpu_torch.ops.ed25519_ladder import ed25519_verify_ladder, ed25519_verify_ladder_w4
    from corda_tpu_torch.ops.ed25519_ladder4096 import ed25519_verify_g4, ed25519_verify_g8
    from corda_tpu_torch.ops.scalar25519 import ed25519_challenge

    tier = Ed25519Tier(4096, 8)
    kernels = (ed25519_challenge, ed25519_verify_ladder, ed25519_verify_ladder_w4,
               ed25519_verify_g8, ed25519_verify_g4)
    (launches, counters, batches, e2e_ms, wall_ms, steady_ms, prof,
     prof_wall_ms, took, _a_batches) = backlog_passes(dev, rows_by_req, requests, classes,
                                                      n_rows, kernels, tier=tier)
    if min(launches["ed25519_challenge"], launches["ed25519_verify_g8"]) == 0 or \
            launches["ed25519_verify_ladder"] or launches["ed25519_verify_ladder_w4"] or \
            launches["ed25519_verify_g4"]:
        raise AssertionError(f"{tier} backlog launches {launches}: want A and G8 only")
    print(f"{tier} backlog: {len(requests)} requests, {n_rows} signatures, {len(batches)} "
          f"device batches, every verdict == oracle where the two rules agree (of the rows "
          f"where they differ, {took[0]} took the cofactored verdict of a full bucket, "
          f"{took[1]} the cofactorless one), device_rows == {n_rows}; launches {launches}; "
          f"counters {counters}")
    print(f"{tier} e2e, first pass: {n_rows} sigs in {e2e_ms:.1f} ms (CUDA events; host "
          f"clock {wall_ms:.1f} ms) = {n_rows / e2e_ms * 1e3:.0f} sigs/s  [{card}]")
    print(f"{tier} e2e, steady pass: {n_rows} sigs in {steady_ms:.1f} ms (CUDA events) = "
          f"{n_rows / steady_ms * 1e3:.0f} sigs/s  [{card}]")
    busy_ms, device_us = device_busy(prof)
    print(f"{tier} profiled pass: {prof_wall_ms:.1f} ms host clock, device busy "
          f"{busy_ms:.1f} ms = {busy_ms / prof_wall_ms:.1%}; by name: "
          + ", ".join(f"{k.split('(')[0]} {v / 1e3:.2f} ms"
                      for k, v in sorted(device_us.items(), key=lambda kv: -kv[1])[:8])
          + f"  [{card}]")
    return launches["ed25519_verify_g8"]


def answer_of(result):
    """A notary answer as comparable data: signature bytes, or the error."""
    if type(result).__name__ == "TransactionSignature":
        return ("signed", result.signature, result.by.encoded)
    return (type(result).__name__, str(result))


def validating_phase(dev, card, stream, window=NOTARY_WINDOW):
    """Phase 13: the validating notary over phase 8's stream with its
    contract-invalid kinds, on each tier: checks and tx/s, and on the
    default tier the host time of each stage (over its first pass, after
    a warm-up; the script's time dropped a steady pass of its own).
    Returns the launch counts of each tier's first pass."""
    import torch

    from corda_tpu_torch.ops.ed25519 import Ed25519Tier
    from corda_tpu_torch.ops.ed25519_ladder import ed25519_verify_ladder, ed25519_verify_ladder_w4
    from corda_tpu_torch.ops.ed25519_ladder4096 import ed25519_verify_g4, ed25519_verify_g8
    from corda_tpu_torch.ops.ed25519_sign import ed25519_comb
    from corda_tpu_torch.ops.scalar25519 import ed25519_challenge
    from corda_tpu_torch.ops.sha256 import sha256_leaves, sha256_merkle_sweep
    from corda_tpu_torch.serving import shutdown_scheduler
    from corda_tpu_torch.testing import CONTRACT_INVALID_KINDS

    n_req = sum(len(w) for w in stream.windows)
    n_moves = sum(k == "signed" for w in stream.kinds for k in w)
    print(f"validating stream (phase 8's): {n_req} requests ({n_moves} moves, "
          f"{n_req - n_moves} adversarial, {len(CONTRACT_INVALID_KINDS)} of them "
          f"contract-invalid) in {len(stream.windows)} windows of {window}")
    common = (ed25519_challenge, sha256_leaves, sha256_merkle_sweep, ed25519_comb)
    ladders = {Ed25519Tier(): ed25519_verify_ladder,
               Ed25519Tier(8192, 4): ed25519_verify_ladder_w4,
               Ed25519Tier(4096, 8): ed25519_verify_g8, Ed25519Tier(4096, 4): ed25519_verify_g4}
    sync = torch.cuda.synchronize
    answers, launches_by_tier = {}, {}
    for tier, ladder in ladders.items():
        try:
            notary_pass(dev, stream, stream.windows[:2], sync=sync, validating=True,
                        tier=tier)  # warm-up
            kernels = common + tuple(ladders.values())
            for k in kernels:
                k.launches = 0
            host_times = {"ids": [], "commit": [], "sign": [], "validate": []}
            timed_tier = tier == Ed25519Tier()
            out, first_s = notary_pass(dev, stream, stream.windows, sync=sync,
                                       host_times=host_times if timed_tier else None,
                                       validating=True, tier=tier)
            launches = {k.__name__: k.launches for k in kernels}
        finally:
            shutdown_scheduler()
        n_signed = check_notary_results(out, stream, dev, oracle=True)
        others = [lad.__name__ for lad in ladders.values() if lad is not ladder]
        if min(launches[k.__name__] for k in common + (ladder,)) == 0 or \
                any(launches[name] for name in others):
            raise AssertionError(f"validating notary on {tier}: launches {launches}")
        answers[tier] = [answer_of(r) for w in out for r in w]
        launches_by_tier[tier] = launches
        print(f"validating notary on {tier}: every request as expected ({n_signed} signed, "
              f"{n_req - n_signed} rejected), every signature verified; launches {launches}")
        print(f"validating notary on {tier}: first pass {n_signed / first_s:.0f} tx/s "
              f"({first_s * 1e3:.1f} ms host clock)  [{card}]")
        if timed_tier:
            per_window = {k: 1e3 * sum(v) / len(v) for k, v in host_times.items()}
            print(f"validating notary on {tier}: host ms per window of {window} (first "
                  f"pass): validation (to_ledger_transaction + verify_ledger_batch) "
                  f"{per_window['validate']:.2f}, id sweep {per_window['ids']:.2f}, commit "
                  f"{per_window['commit']:.2f}, signing {per_window['sign']:.2f}  [{card}]")
    first = next(iter(answers.values()))
    for tier, ans in answers.items():
        if ans != first:
            bad = [i for i, (a, b) in enumerate(zip(ans, first)) if a != b]
            raise AssertionError(f"{tier}'s answers differ from the default tier's at {bad[:10]}")
    print(f"validating notary: the {len(answers)} tiers' answers equal request for request, "
          f"signature bytes included ({len(first)} requests)")
    return launches_by_tier


def cofactored_phase(dev, card, pool, n=8192):
    """Phase 14: full ed25519 buckets under the cofactored rule of the
    reference's RLC route, on each of the four tiers. ``pool`` (phase 3's
    lanes) plus the 8 small-order encodings as A and as R and an R of small
    order that the cofactorless rule accepts, tiled to ``n`` rows: a full
    bucket through dispatch_signature_rows equals the port's
    ``verify_single`` row by row (the tier's ladder launched, its counter
    zeroed just before and read just after, the other ladders not), the
    ladder's cofactored launch equals its plain version (at ``n`` lanes,
    and that result cut to 1,024 and tiled to 4n), a partial bucket
    equals the cofactorless oracle; then each ladder's time in both modes,
    in turns. Returns the launches of each tier's full-bucket run."""
    import numpy as np
    import torch

    from corda_tpu_torch.batchverify import verify_rows
    from corda_tpu_torch.crypto import PublicKey, ed25519_host
    from corda_tpu_torch.ops import ed25519_ladder as b
    from corda_tpu_torch.ops import ed25519_ladder4096 as g
    from corda_tpu_torch.ops.ed25519 import Ed25519Tier
    from corda_tpu_torch.ops.scalar25519 import challenge_windows_plain
    from corda_tpu_torch.testing import cofactored_lanes
    from corda_tpu_torch.verifier import dispatch_signature_rows

    t0 = time.perf_counter()
    extra = cofactored_lanes(14)
    distinct = [(pk, s, m) for _k, pk, s, m in extra] + list(pool)
    cof = verify_rows(distinct)
    plain = [ed25519_host.verify(*t) for t in distinct]
    differ = sum(c != p for c, p in zip(cof, plain))
    rows = [distinct[i % len(distinct)] for i in range(n)]
    want_cof = [cof[i % len(distinct)] for i in range(n)]
    want_plain = [plain[i % len(distinct)] for i in range(n)]
    key_rows = [(PublicKey(4, pk), s, m) for pk, s, m in rows]
    print(f"cofactored bucket: {n} rows ({len(distinct)} distinct: phase 3's lanes and "
          f"{len(extra)} small-order kinds; the two rules differ on {differ} distinct rows), "
          f"oracles in {time.perf_counter() - t0:.1f} s")
    tiers = {Ed25519Tier(): (b.ed25519_verify_ladder, b.verify_ladder_plain, b),
             Ed25519Tier(8192, 4): (b.ed25519_verify_ladder_w4, b.verify_ladder_plain, b),
             Ed25519Tier(4096, 8): (g.ed25519_verify_g8, g.verify_plain_g, g),
             Ed25519Tier(4096, 4): (g.ed25519_verify_g4, g.verify_plain_g, g)}
    ladders = [v[0] for v in tiers.values()]
    packed = torch.from_numpy(pack_triples(rows, cofactored=True)).to(dev)
    win = challenge_windows_plain(packed)
    out = {}
    for tier, (ladder, plain_fn, mod) in tiers.items():
        for lad in ladders:
            lad.launches = 0
        torch.cuda.synchronize()
        got = dispatch_signature_rows(key_rows, min_bucket=n, device=dev, tier=tier).collect()
        launches = {lad.__name__: lad.launches for lad in ladders}
        if got.tolist() != want_cof:
            bad = [i for i, (x, y) in enumerate(zip(got.tolist(), want_cof)) if x != y]
            raise AssertionError(f"{tier}: full bucket != verify_single at rows {bad[:20]}")
        if launches[ladder.__name__] == 0 or any(
                v for k, v in launches.items() if k != ladder.__name__):
            raise AssertionError(f"{tier}: full-bucket launches {launches}")
        partial = dispatch_signature_rows(key_rows, min_bucket=n + 1, device=dev,
                                          tier=tier).collect()
        if partial.tolist() != want_plain:
            raise AssertionError(f"{tier}: partial bucket != the cofactorless oracle")
        table = mod.ladder_table(dev)
        got_k = ladder(packed, win, table, True)
        want_k = plain_fn(packed, win, table, tier.fixed_win, True)
        torch.cuda.synchronize()
        if not torch.equal(got_k, want_k) or got_k.cpu().tolist() != want_cof:
            raise AssertionError(f"{ladder.__name__} cofactored != plain or verify_single")
        # the same rows cut to 1,024 lanes and tiled to 32,768
        for lanes in (1024, 4 * n):
            reps = -(-lanes // n)
            got_l = ladder(packed.repeat(reps, 1)[:lanes].contiguous(),
                           win.repeat(1, reps)[:, :lanes].contiguous(), table, True)
            torch.cuda.synchronize()
            if not torch.equal(got_l, want_k.repeat(reps)[:lanes]):
                raise AssertionError(f"{ladder.__name__} cofactored != plain at {lanes} lanes")
        acc = {False: [], True: []}
        for mode in (False, True, True, False):
            acc[mode].append(cuda_ms(lambda: ladder(packed, win, table, mode), 5))
        ms = {mode: sum(v) / len(v) for mode, v in acc.items()}
        print(f"{tier}: full bucket == verify_single ({n} rows, {int(got.sum())} accepted), "
              f"partial == cofactorless oracle, {ladder.__name__} cofactored == plain at "
              f"1024, {n} and {4 * n} lanes; "
              f"launches {launches}; {ladder.__name__} at B={n}: cofactorless {ms[False]:.4f} "
              f"ms, cofactored {ms[True]:.4f} ms ({ms[True] / ms[False] - 1:+.1%})  [{card}]")
        out[tier] = launches[ladder.__name__]
    return out


def resolve_outcome(res) -> tuple:
    """A resolve's result as comparable data."""
    return (list(res.order), [list(lvl) for lvl in res.levels], res.n_sigs,
            sorted((ref.txhash.bytes, ref.index) for ref in res.consumed))


def cold_ids(stxs) -> None:
    for stx in stxs:
        object.__getattribute__(stx.tx, "__dict__").pop("_id", None)


def check_primed_ids(stxs) -> None:
    """Every primed id equals the id hashlib gives the same bytes on the
    host (a fresh copy of the wire transaction)."""
    from corda_tpu_torch.serialization import deserialize

    for stx in stxs:
        primed = object.__getattribute__(stx.tx, "__dict__").get("_id")
        if primed != deserialize(stx.tx_bits).id:
            raise AssertionError(f"primed id {primed} != the bytes' id of {stx}")


def resolve_pass(dev, dag, allowed, sync, **kw):
    """One resolve of ``dag`` on ``dev`` with every id cache cold: (result,
    host-clock seconds)."""
    from corda_tpu_torch.parallel import verify_transaction_dag

    cold_ids(dag.values())
    sync()
    t0 = time.perf_counter()
    res = verify_transaction_dag(dag, allowed_missing_fn=allowed, device=dev,
                                 window=RESOLVE_WINDOW, depth=RESOLVE_DEPTH, **kw)
    sync()
    return res, time.perf_counter() - t0


def resolve_launches(dev, dag, allowed, sync, want_host, tier=None):
    """The first resolve of ``dag`` on the card, with the kernels' launch
    counters and the scheduler's batch counter read around it: checked
    against the host route's result, its ids against hashlib, its launches
    (A, C, D and the tier's ladder risen; the other ladders and E at 0).
    Returns (launches, scheduler batches, seconds)."""
    from corda_tpu_torch.ops.ed25519 import Ed25519Tier
    from corda_tpu_torch.ops.ed25519_ladder import ed25519_verify_ladder, ed25519_verify_ladder_w4
    from corda_tpu_torch.ops.ed25519_ladder4096 import ed25519_verify_g4, ed25519_verify_g8
    from corda_tpu_torch.ops.ed25519_sign import ed25519_comb
    from corda_tpu_torch.ops.scalar25519 import ed25519_challenge
    from corda_tpu_torch.ops.sha256 import sha256_leaves, sha256_merkle_sweep
    from corda_tpu_torch.serving import device_scheduler

    tier = tier or Ed25519Tier()
    ladders = {Ed25519Tier(): ed25519_verify_ladder,
               Ed25519Tier(8192, 4): ed25519_verify_ladder_w4,
               Ed25519Tier(4096, 8): ed25519_verify_g8, Ed25519Tier(4096, 4): ed25519_verify_g4}
    kernels = (ed25519_challenge, sha256_leaves, sha256_merkle_sweep, ed25519_comb,
               *ladders.values())
    sched = device_scheduler(dev, tier)
    batches0 = sched.counters["serving.batches"]
    for k in kernels:
        k.launches = 0
    res, secs = resolve_pass(dev, dag, allowed, sync, tier=tier)
    launches = {k.__name__: k.launches for k in kernels}
    batches = sched.counters["serving.batches"] - batches0
    if resolve_outcome(res) != want_host:
        raise AssertionError(f"the resolve on {tier} differs from the host route's")
    check_primed_ids(dag.values())
    must = (ed25519_challenge, sha256_leaves, sha256_merkle_sweep, ladders[tier])
    if min(launches[k.__name__] for k in must) == 0 or any(
            launches[k.__name__] for k in kernels if k not in must):
        raise AssertionError(f"resolve on {tier}: launches {launches}")
    if batches == 0:
        raise AssertionError("the resolve did not ride the shared scheduler")
    return launches, batches, secs


def resolve_stage_times(dev, dag, allowed, sync) -> dict:
    """Host seconds by stage over one resolve (a pass of its own, outside
    the timed ones): each stage's function, on its module or class,
    wrapped with a timer for that pass, and put back."""
    from corda_tpu_torch.ledger import WireTransaction
    from corda_tpu_torch.ops.txid import PendingIdCheck
    from corda_tpu_torch.parallel import wavefront
    from corda_tpu_torch.serving import DeviceScheduler, FuturePending

    stages = {"sort": (wavefront, "topological_levels"),
              "ids": (wavefront, "dispatch_check_ids"),
              "submit": (DeviceScheduler, "submit_transactions"),
              "ids_collect": (PendingIdCheck, "collect"),
              "verdicts": (FuturePending, "collect"),
              "walk": (wavefront, "_walk_levels"),
              "ltx": (WireTransaction, "to_ledger_transaction"),
              "contracts": (wavefront, "verify_ledger_batch")}
    acc = {k: [] for k in stages}
    originals = {k: getattr(owner, name) for k, (owner, name) in stages.items()}
    try:
        for k, (owner, name) in stages.items():
            setattr(owner, name, timed(originals[k], acc[k]))
        _res, secs = resolve_pass(dev, dag, allowed, sync)
    finally:
        for k, (owner, name) in stages.items():
            setattr(owner, name, originals[k])
    total = {k: sum(v) for k, v in acc.items()}
    total["walk"] -= total["ltx"]  # the consumed set, resolution, outputs
    total["ltx"] += total.pop("contracts")
    total["pass"] = secs
    return total


def paper_chain():
    """A CommercialPaper issue, a move and its redemption against Cash, with
    the Cash issue that pays it: (signed transactions, notary)."""
    from corda_tpu_torch.finance import (
        CASH_PROGRAM_ID,
        CP_PROGRAM_ID,
        CashState,
        CommercialPaperState,
        Issue,
        Move,
        Redeem,
    )
    from corda_tpu_torch.ledger import (
        Amount,
        Issued,
        PartyAndReference,
        PrivacySalt,
        TimeWindow,
        TransactionBuilder,
    )
    from corda_tpu_torch.testing import _party

    alice, akp = _party(b"Paper Issuer")
    bob, bkp = _party(b"Paper Holder")
    notary, _nkp = _party(b"Paper Notary")
    token = Issued(PartyAndReference(alice, b"\x01"), "GBP")
    maturity = 1_800_000_000.0
    rng = random.Random(15)

    def builder(tw=None):
        b = TransactionBuilder(notary=notary)
        b.set_privacy_salt(PrivacySalt(rng.randbytes(32)))
        if tw is not None:
            b.set_time_window(tw)
        return b

    b = builder()
    b.add_output_state(CashState(Amount(1000, token), alice), CASH_PROGRAM_ID)
    b.add_command(Issue(), alice.owning_key)
    cash = b.sign_initial_transaction(akp)
    b = builder(TimeWindow(until_time=int((maturity - 86400) * 1e6)))
    b.add_output_state(CommercialPaperState(token.issuer, alice, Amount(1000, token), maturity),
                       CP_PROGRAM_ID)
    b.add_command(Issue(), alice.owning_key)
    issue = b.sign_initial_transaction(akp)
    b = builder()
    b.add_input_state(issue.tx.out_ref(0))
    b.add_output_state(issue.tx.outputs[0].data.with_new_owner(bob), CP_PROGRAM_ID)
    b.add_command(Move(), alice.owning_key)
    move = b.sign_initial_transaction(akp)
    b = builder(TimeWindow(from_time=int((maturity + 60) * 1e6)))
    b.add_input_state(move.tx.out_ref(0))
    b.add_input_state(cash.tx.out_ref(0))
    b.add_output_state(CashState(Amount(1000, token), bob), CASH_PROGRAM_ID)
    b.add_command(Redeem(), bob.owning_key)
    b.add_command(Move(), alice.owning_key)
    redeem = b.sign_initial_transaction(bkp, akp)
    return [cash, issue, move, redeem], notary


def resolve_failures(dev, chain, notary, sync) -> None:
    """Phase 15c: each failure kind raises on the card through the shared
    scheduler."""
    import dataclasses

    from corda_tpu_torch.crypto import SecureHash
    from corda_tpu_torch.finance import CASH_PROGRAM_ID, CashState, Move
    from corda_tpu_torch.ledger import (
        Amount,
        SignedTransaction,
        StateAndRef,
        StateRef,
        TransactionBuilder,
        TransactionVerificationException,
    )
    from corda_tpu_torch.parallel import (
        DoubleSpendInDagError,
        UnresolvedStateError,
        verify_transaction_dag,
        wavefront,
    )
    from corda_tpu_torch.serialization import deserialize
    from corda_tpu_torch.testing import _party
    from corda_tpu_torch.verifier import InvalidSignatureError

    owner, okp = _party(b"Chain Owner")
    allowed = lambda s: {notary.owning_key}  # noqa: E731
    dag = {stx.id: stx for stx in chain}
    token = chain[0].tx.outputs[0].data.amount.token

    def move(spend, amount=1000, to=owner):
        b = TransactionBuilder(notary=notary)
        b.add_input_state(spend)
        b.add_output_state(CashState(Amount(amount, token), to), CASH_PROGRAM_ID)
        b.add_command(Move(), owner.owning_key)
        return b

    def expect(name, err_cls, bad_dag, match=None):
        cold_ids(bad_dag.values())
        try:
            verify_transaction_dag(bad_dag, allowed_missing_fn=allowed, device=dev,
                                   window=RESOLVE_WINDOW, depth=RESOLVE_DEPTH)
        except err_cls as e:
            if match is not None and match not in str(e):
                raise AssertionError(f"{name}: {e}") from e
            print(f"resolve failure on the card, {name}: {type(e).__name__}")
            return
        raise AssertionError(f"{name}: the resolve did not raise {err_cls.__name__}")

    # a forged chain link in window 2: another move of the same input,
    # carrying the original's signature, keyed under the original's id
    at = 2 * RESOLVE_WINDOW + RESOLVE_WINDOW // 2
    orig = chain[at]
    forged_wtx = move(chain[at - 1].tx.out_ref(0), to=notary).to_wire_transaction()
    forged = dict(dag)
    forged[orig.id] = SignedTransaction.create(forged_wtx, list(orig.sigs))
    walks = []
    walk = wavefront._walk_levels
    wavefront._walk_levels = lambda wl, *a: walks.append(len(wl)) or walk(wl, *a)
    try:
        expect("forged chain link", TransactionVerificationException, forged,
               "transaction id mismatch")
    finally:
        wavefront._walk_levels = walk
    if len(walks) != 2:
        raise AssertionError(f"the forged link raised after {len(walks)} windows, not at window 2")
    for stx in forged.values():
        cached = object.__getattribute__(stx.tx, "__dict__").get("_id")
        if cached is not None and cached != deserialize(stx.tx_bits).id:
            raise AssertionError(f"a claimed id stayed cached on {stx}")
    print("resolve failure on the card, forged chain link: raised at window 2, no claimed id "
          "left cached")

    k = len(chain) // 3
    sig = chain[k].sigs[0]
    tampered = dict(dag)
    tampered[chain[k].id] = dataclasses.replace(chain[k], sigs=(dataclasses.replace(
        sig, signature=sig.signature[:9] + bytes([sig.signature[9] ^ 1]) + sig.signature[10:]),))
    expect("tampered signature", InvalidSignatureError, tampered)

    spend = move(chain[len(chain) // 2].tx.out_ref(0)).sign_initial_transaction(okp)
    expect("double spend", DoubleSpendInDagError, {**dag, spend.id: spend})

    ghost = StateAndRef(chain[0].tx.outputs[0], StateRef(SecureHash(bytes(range(32))), 0))
    orphan = move(ghost).sign_initial_transaction(okp)
    expect("orphan", UnresolvedStateError, {**dag, orphan.id: orphan})

    leak = move(chain[-1].tx.out_ref(0), amount=999).sign_initial_transaction(okp)
    expect("non-conserving Cash move", TransactionVerificationException, {**dag, leak.id: leak},
           "value not conserved")


def resolve_phase(dev, card, hops=RESOLVE_HOPS, n_gen=GEN_TXS, sync=None) -> None:
    """Phase 15: the back-chain resolve on the card (BASELINE config #4),
    a generated DAG on two tiers, each failure kind, and a CommercialPaper
    chain."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from corda_tpu_torch.ops.ed25519 import Ed25519Tier
    from corda_tpu_torch.serving import shutdown_scheduler
    from corda_tpu_torch.testing import GeneratedLedger, back_chain

    sync = sync or torch.cuda.synchronize
    t0 = time.perf_counter()
    chain, notary = back_chain(hops, seed=20261019, device=dev)
    dag = {stx.id: stx for stx in chain}
    allowed = lambda s: {notary.owning_key}  # noqa: E731
    n_windows = -(-len(chain) // RESOLVE_WINDOW)
    print(f"back-chain: {len(chain)} transactions, {sum(len(s.sigs) for s in chain)} signatures,"
          f" built in {time.perf_counter() - t0:.1f} s (signed on the card)")
    try:
        # (a) BASELINE config #4 through the shared scheduler
        t0 = time.perf_counter()
        host = resolve_outcome(resolve_pass(dev, dag, allowed, sync, use_device=False)[0])
        host_s = time.perf_counter() - t0
        if len(host[1]) != len(chain) or any(len(lvl) != 1 for lvl in host[1]) or \
                host[2] != len(chain):
            raise AssertionError("the host route's levels or signatures are not the chain's")
        launches, batches, first_s = resolve_launches(dev, dag, allowed, sync, host)
        steady = []
        for _ in range(3):
            res, secs = resolve_pass(dev, dag, allowed, sync)
            if resolve_outcome(res) != host:
                raise AssertionError("a steady resolve differs from the host route's")
            steady.append(secs)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res, prof_s = resolve_pass(dev, dag, allowed, sync)
        if resolve_outcome(res) != host:
            raise AssertionError("the profiled resolve differs from the host route's")
        stages = resolve_stage_times(dev, dag, allowed, sync)
        n = len(chain)
        rates = sorted(n / s for s in steady)
        print(f"resolve (BASELINE config #4): {n} transactions, {n} levels of one, {n} "
              f"signatures, {n_windows} windows of {RESOLVE_WINDOW} at depth {RESOLVE_DEPTH}, "
              f"ids cold every pass; == the host route ({host_s:.2f} s), every primed id == "
              f"hashlib's; launches {launches}; {batches} scheduler batches")
        print(f"resolve: first pass {n / first_s:.0f} tx/s ({first_s * 1e3:.1f} ms host clock), "
              f"steady median {statistics.median(rates):.0f} tx/s over 3 (min {rates[0]:.0f}, "
              f"max {rates[-1]:.0f}, spread {(rates[-1] - rates[0]) / statistics.median(rates):.1%})"
              f"  [{card}]")
        busy_ms, device_us = device_busy(prof)
        print(f"resolve, profiled pass: {prof_s * 1e3:.1f} ms host clock, device busy "
              f"{busy_ms:.2f} ms = {busy_ms / (prof_s * 1e3):.2%}; by name: "
              + ", ".join(f"{k.split('(')[0]} {v / 1e3:.3f} ms"
                          for k, v in sorted(device_us.items(), key=lambda kv: -kv[1])[:8])
              + f"  [{card}]")
        per_window = {k: v * 1e3 / n_windows for k, v in stages.items()}
        print(f"resolve, host ms a window of {RESOLVE_WINDOW} by stage (a pass of its own, "
              f"{stages['pass'] * 1e3:.1f} ms): level sort {per_window['sort']:.2f}, id plan "
              f"and enqueue {per_window['ids']:.2f}, flatten and submit "
              f"{per_window['submit']:.2f}, id collect {per_window['ids_collect']:.2f}, verdict "
              f"collect {per_window['verdicts']:.2f}, consumed set and resolution "
              f"{per_window['walk']:.2f}, to_ledger_transaction + verify_ledger_batch "
              f"{per_window['ltx']:.2f}  [{card}]")

        # (b) a generated DAG on B8 and G8
        t0 = time.perf_counter()
        gen = GeneratedLedger(seed=20261019, n_parties=GEN_PARTIES, device=dev)
        gdag = gen.generate(n_gen)
        gallowed = lambda s: {gen.notary.owning_key}  # noqa: E731
        g_sigs = sum(len(s.sigs) for s in gdag.values())
        print(f"generated DAG: {len(gdag)} transactions, {g_sigs} signatures, built in "
              f"{time.perf_counter() - t0:.1f} s (signed on the card, a batch a transaction)")
        ghost_res, ghost_s = resolve_pass(dev, gdag, gallowed, sync, use_device=False)
        ghost = resolve_outcome(ghost_res)
        for tier in (Ed25519Tier(), Ed25519Tier(4096, 8)):
            g_launches, g_batches, g_s = resolve_launches(dev, gdag, gallowed, sync, ghost, tier)
            print(f"generated DAG on {tier}: {len(ghost[1])} levels (widest "
                  f"{max(len(lvl) for lvl in ghost[1])}), == the host route ({ghost_s:.2f} s), "
                  f"every primed id == "
                  f"hashlib's; launches {g_launches}; {g_batches} scheduler batches; first pass "
                  f"{len(gdag) / g_s:.0f} tx/s  [{card}]")
        print("generated DAG: the two tiers' results equal (each == the host route's)")

        # (c) failures on the card, and a CommercialPaper chain that resolves
        resolve_failures(dev, chain, notary, sync)
        paper, p_notary = paper_chain()
        pdag = {stx.id: stx for stx in paper}
        p_allowed = lambda s: {p_notary.owning_key}  # noqa: E731
        p_host = resolve_outcome(resolve_pass(dev, pdag, p_allowed, sync, use_device=False)[0])
        p_res = resolve_outcome(resolve_pass(dev, pdag, p_allowed, sync)[0])
        if p_res != p_host or len(p_res[0]) != 4:
            raise AssertionError("the CommercialPaper chain did not resolve as on the host")
        check_primed_ids(paper)
        print(f"CommercialPaper issue -> move -> redeem with its Cash: resolved on the card, "
              f"{len(p_res[1])} levels, == the host route")
    finally:
        shutdown_scheduler()


SERVICE_SCHEMES = {2: "secp256k1", 3: "secp256r1", 4: "ed25519", 5: "sphincs", 7: "bls"}


def service_pass(svc, st, sync, threads=SERVICE_THREADS) -> tuple[list, float]:
    """Every transaction of ``st`` through ``svc.verify_signed`` from
    ``threads`` threads (each id cache cold), and every future waited for:
    (the outcomes in stream order, host-clock seconds)."""
    from corda_tpu_torch.testing.service_stream import future_outcome

    cold_ids(st.stxs)
    futs = [None] * len(st.stxs)

    def submit(k):
        for i in range(k, len(st.stxs), threads):
            futs[i] = svc.verify_signed(st.stxs[i], st.resolve, st.allowed[i])

    sync()
    t0 = time.perf_counter()
    workers = [threading.Thread(target=submit, args=(k,), daemon=True)
               for k in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=600)
    if any(w.is_alive() for w in workers):
        raise AssertionError("a submitting thread did not finish")
    outcomes = [future_outcome(f) for f in futs]
    sync()
    return outcomes, time.perf_counter() - t0


def service_run(dev, st, sync, want, threads=SERVICE_THREADS, **kw):
    """One pass through a fresh ``BatchedVerifierService(device=dev, **kw)``,
    its outcomes held against ``want`` and its stats against the rows:
    (stats, seconds)."""
    from corda_tpu_torch.verifier import BatchedVerifierService

    svc = BatchedVerifierService(device=dev, **kw)
    try:
        got, secs = service_pass(svc, st, sync, threads)
    finally:
        svc.shutdown()
    bad = [(i, st.kinds[i], g, w) for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if bad:
        raise AssertionError(f"service {kw}: {len(bad)} outcomes differ, first {bad[:3]}")
    live = [s for s, k in zip(st.stxs, st.kinds) if k != "composite_as_signer"]
    rows = sum(len(s.sigs) for s in live)
    host_rows = sum(1 for s in live for sig in s.sigs if sig.by.scheme_id == 7)
    want_device = rows - host_rows if kw.get("use_device", True) else 0
    stats = svc.stats
    if (stats["txs"], stats["sigs"], stats["device_sigs"]) != (len(live), rows, want_device):
        raise AssertionError(f"service {kw}: stats {stats} do not add up to {len(live)} "
                             f"transactions, {rows} rows, {want_device} on the card")
    return stats, secs


def service_stage_times(dev, st, sync) -> dict:
    """Host seconds by stage over one scheduler-route pass of its own:
    flatten and submit, the collect of each batch's buckets, the signer
    algebra, the contract run (to_ledger_transaction and verify)."""
    from corda_tpu_torch.ledger import LedgerTransaction, WireTransaction
    from corda_tpu_torch.serving import DeviceScheduler
    from corda_tpu_torch.serving import scheduler as sched_mod
    from corda_tpu_torch.verifier import BatchedVerifierService, PendingRows

    stages = {"submit": (DeviceScheduler, "submit_transactions"),
              "collect": (PendingRows, "collect"),
              "algebra": (sched_mod, "tx_report_from_mask"),
              "ltx": (WireTransaction, "to_ledger_transaction"),
              "contracts": (LedgerTransaction, "verify")}
    acc = {k: [] for k in stages}
    originals = {k: getattr(owner, name) for k, (owner, name) in stages.items()}
    svc = BatchedVerifierService(device=dev)
    try:
        for k, (owner, name) in stages.items():
            setattr(owner, name, timed(originals[k], acc[k]))
        _got, secs = service_pass(svc, st, sync)
    finally:
        for k, (owner, name) in stages.items():
            setattr(owner, name, originals[k])
        svc.shutdown()
    total = {k: sum(v) for k, v in acc.items()}
    total["contracts"] += total.pop("ltx")
    total["pass"] = secs
    total["batches"] = svc.stats["batches"]
    return total


def service_serial_times(st) -> dict:
    """Host seconds on one thread over the whole stream, every id cold: the
    ids and signable bytes (``flatten_signature_rows``), the BLS rows'
    verify (settled on the scheduler's dispatcher thread), and the
    contract run (``to_ledger_transaction`` + ``verify``)."""
    from corda_tpu_torch.crypto import is_valid
    from corda_tpu_torch.verifier import flatten_signature_rows

    cold_ids(st.stxs)
    t0 = time.perf_counter()
    rows = flatten_signature_rows(st.stxs)[0]
    out = {"flatten": time.perf_counter() - t0}
    t0 = time.perf_counter()
    for key, sig, msg in rows:
        if key.scheme_id == 7:
            is_valid(key, sig, msg)
    out["bls"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for stx in st.stxs:
        try:
            stx.tx.to_ledger_transaction(st.resolve).verify()
        except Exception:  # the three contract kinds fail here, as they must
            pass
    out["contracts"] = time.perf_counter() - t0
    return out


def substream(st, keep):
    """The transactions of ``st`` at the indices ``keep``, in order."""
    import dataclasses

    return dataclasses.replace(st, stxs=[st.stxs[i] for i in keep],
                               kinds=[st.kinds[i] for i in keep],
                               allowed=[st.allowed[i] for i in keep],
                               expected=[st.expected[i] for i in keep])


def service_window_refused(dev, st, sync) -> None:
    """The composite key given as an individual signer on the windowed
    route: the ``SERVICE_WINDOW`` requests around it, one full window,
    fail whole with its ``CryptoError``, as the reference's ``_flush``
    fails them, on the card and on the host route."""
    from corda_tpu_torch.verifier import BatchedVerifierService

    at = st.kinds.index("composite_as_signer")
    start = max(0, min(at - SERVICE_WINDOW // 2, len(st.stxs) - SERVICE_WINDOW))
    sub = substream(st, range(start, start + SERVICE_WINDOW))
    for use_device in (True, False):
        svc = BatchedVerifierService(device=dev, use_device=use_device, use_scheduler=False,
                                     max_batch=SERVICE_WINDOW, window_s=600.0)
        try:
            got, _s = service_pass(svc, sub, sync)
        finally:
            svc.shutdown()
        if got != [("CryptoError", frozenset())] * SERVICE_WINDOW or svc.stats["txs"]:
            raise AssertionError(f"windowed route (use_device={use_device}): the window "
                                 f"holding a composite signer gave {set(got)}, {svc.stats}")
    print(f"service, windowed route: the window of {SERVICE_WINDOW} requests holding a "
          "composite key as a signer failed whole with CryptoError, as in the reference, "
          "on the card and on the host route")


def service_failed_dispatch(dev, st, sync) -> None:
    """No failover: the secp256k1 bucket's dispatch made to fail
    (``_dispatch_bucket`` patched here, for this check only) fails every
    request that holds a secp256k1 row, and on the windowed route every
    request of its window, with the error; no request comes to another
    outcome than the error or its own."""
    from corda_tpu_torch.serving import shutdown_scheduler
    from corda_tpu_torch.verifier import BatchedVerifierService
    from corda_tpu_torch.verifier import batch as verifier_batch

    sub = substream(st, [i for i in range(SERVICE_FAILED_TXS)
                         if st.kinds[i] != "composite_as_signer"])
    real = verifier_batch._dispatch_bucket

    def lost(scheme_id, *args):
        if scheme_id == 2:
            raise RuntimeError("injected dispatch failure of the secp256k1 bucket")
        return real(scheme_id, *args)

    lost_err = ("RuntimeError", frozenset())
    holds = [any(sig.by.scheme_id == 2 for sig in stx.sigs) for stx in sub.stxs]
    verifier_batch._dispatch_bucket = lost
    try:
        for use_scheduler in (False, True):
            # the windowed route in one window of every request
            window = {} if use_scheduler else {"max_batch": len(sub.stxs), "window_s": 600.0}
            svc = BatchedVerifierService(device=dev, use_scheduler=use_scheduler, **window)
            try:
                got, _s = service_pass(svc, sub, sync)
            finally:
                svc.shutdown()
            if any(g != lost_err for g, h in zip(got, holds) if h) or any(
                    g not in (lost_err, w) for g, w in zip(got, sub.expected)) or \
                    (not use_scheduler and any(g != lost_err for g in got)):
                raise AssertionError(f"scheduler={use_scheduler}: a failed dispatch did not "
                                     "fail its requests")
    finally:
        verifier_batch._dispatch_bucket = real
        shutdown_scheduler()
    print(f"failed dispatch: the secp256k1 bucket's dispatch made to fail over "
          f"{len(sub.stxs)} transactions ({sum(holds)} with a secp256k1 row): every request "
          "batched with one failed with the error, on the windowed (one window) and the "
          "scheduler route; nothing failed over to the host")


def service_filtered(st) -> None:
    """Tear-offs of the phase's first FILTERED_TXS transactions (inputs,
    notary and time window revealed) verify against each one's id; a
    tampered component and a hidden group fail as in the reference."""
    import dataclasses

    from corda_tpu_torch.ledger import (
        ComponentGroupType,
        FilteredTransaction,
        FilteredTransactionVerificationException,
    )

    shown = (ComponentGroupType.INPUTS, ComponentGroupType.NOTARY,
             ComponentGroupType.TIMEWINDOW)
    t0 = time.perf_counter()
    ftxs = []
    for stx in st.stxs[:FILTERED_TXS]:
        ftx = FilteredTransaction.build(stx.tx, lambda _c, g: g in shown)
        ftx.verify()
        ftx.check_all_components_visible(ComponentGroupType.INPUTS)
        if ftx.id != stx.id:
            raise AssertionError("a tear-off's id is not its transaction's")
        ftxs.append(ftx)
    ms = (time.perf_counter() - t0) * 1e3
    fg = ftxs[0].filtered_groups[0]
    c = fg.components[0]
    bad = dataclasses.replace(ftxs[0], filtered_groups=(dataclasses.replace(
        fg, components=(dataclasses.replace(
            c, opaque_bytes=c.opaque_bytes[:-1] + bytes([c.opaque_bytes[-1] ^ 1])),)),)
        + ftxs[0].filtered_groups[1:])
    for what, fn in (("tampered component", bad.verify),
                     ("hidden group", lambda: ftxs[1].check_all_components_visible(
                         ComponentGroupType.COMMANDS))):
        try:
            fn()
        except FilteredTransactionVerificationException:
            continue
        raise AssertionError(f"a tear-off with a {what} passed")
    print(f"filtered transactions: {len(ftxs)} tear-offs (inputs, notary, time window) built "
          f"and verified against their ids in {ms:.1f} ms host clock; a tampered component "
          "and a hidden group raise FilteredTransactionVerificationException")


def service_phase(dev, card, n=SERVICE_TXS, sync=None, profiled=True) -> dict:
    """Phase 17: the verifier service on the card. Returns the launches of
    the first B8 pass, the stream and the steady median rate."""
    import statistics
    from collections import Counter

    import torch

    from corda_tpu_torch.ledger.attachment_code import set_attachment_fetcher
    from corda_tpu_torch.ops.ed25519 import Ed25519Tier
    from corda_tpu_torch.ops.ed25519_ladder import ed25519_verify_ladder, ed25519_verify_ladder_w4
    from corda_tpu_torch.ops.ed25519_ladder4096 import ed25519_verify_g4, ed25519_verify_g8
    from corda_tpu_torch.ops.ed25519_sign import ed25519_comb
    from corda_tpu_torch.ops.scalar25519 import ed25519_challenge
    from corda_tpu_torch.ops.secp256_ladder import ecdsa_verify_k1, ecdsa_verify_r1
    from corda_tpu_torch.ops.sha256 import sha256_leaves, sha256_merkle_sweep
    from corda_tpu_torch.ops.sphincs_batch import sphincs_verify
    from corda_tpu_torch.serving import shutdown_scheduler
    from corda_tpu_torch.testing.service_stream import service_stream

    sync = sync or torch.cuda.synchronize
    kernels = (ed25519_challenge, ed25519_verify_ladder, ed25519_verify_ladder_w4,
               ed25519_verify_g8, ed25519_verify_g4, ecdsa_verify_k1, ecdsa_verify_r1,
               sphincs_verify, ed25519_comb, sha256_leaves, sha256_merkle_sweep)
    t0 = time.perf_counter()
    st = service_stream(n, seed=20261017, device=dev)
    rows = Counter(SERVICE_SCHEMES.get(sig.by.scheme_id, "composite")
                   for s in st.stxs for sig in s.sigs)
    print(f"verifier service: {n} transactions ({dict(Counter(st.kinds))}), {sum(rows.values())} "
          f"signature rows ({dict(rows)}), built in {time.perf_counter() - t0:.1f} s (ed25519 "
          "signed on the card)")
    set_attachment_fetcher(st.store.get)
    try:
        taken: Counter = Counter()
        sample = []
        for i, k in enumerate(st.kinds):
            taken[k] += 1
            if taken[k] <= SERVICE_HOST_EACH:
                sample.append(i)
        host_stats, host_s = service_run(dev, substream(st, sample), sync,
                                         [st.expected[i] for i in sample], use_device=False)
        print(f"service, host route (use_device=False) over the first {SERVICE_HOST_EACH} "
              f"transactions of each of the {len(taken)} kinds ({len(sample)}): every outcome "
              f"== the oracle, {host_stats}, {host_s:.2f} s")

        def launches_of(stream, **kw):
            for k in kernels:
                k.launches = 0
            stats, secs = service_run(dev, stream, sync, stream.expected, **kw)
            return {k.__name__: k.launches for k in kernels}, stats, secs

        # the windowed route's stream leaves out the composite key as a
        # signer, which fails its whole window (service_window_refused)
        st_win = substream(st, [i for i, k in enumerate(st.kinds)
                                if k != "composite_as_signer"])
        b8, b8_stats, first_s = launches_of(st)
        must = ("ed25519_challenge", "ed25519_verify_ladder", "ecdsa_verify_k1",
                "ecdsa_verify_r1", "sphincs_verify")
        if min(b8[k] for k in must) == 0 or any(v for k, v in b8.items() if k not in must):
            raise AssertionError(f"service on B8: launches {b8}")
        steady = [service_run(dev, st, sync, st.expected)[1] for _ in range(STEADY_PASSES)]
        g8, g8_stats, g8_s = launches_of(st, tier=Ed25519Tier(4096, 8))
        must_g = ("ed25519_challenge", "ed25519_verify_g8") + must[2:]
        if min(g8[k] for k in must_g) == 0 or any(v for k, v in g8.items() if k not in must_g):
            raise AssertionError(f"service on G8: launches {g8}")
        win, win_stats, win_s = launches_of(st_win, use_scheduler=False, window_s=0.005)
        if min(win[k] for k in must) == 0 or any(v for k, v in win.items() if k not in must):
            raise AssertionError(f"service, windowed route: launches {win}")
        rates = sorted(n / s for s in steady)
        med = statistics.median(rates)
        print(f"service (scheduler route, B8): every outcome == the host route == the oracle "
              f"({len(st.kinds)} transactions, {sum(e is not None for e in st.expected)} "
              f"adversarial); stats {b8_stats}; launches {b8}")
        print(f"service: first pass {n / first_s:.0f} verified tx/s ({first_s * 1e3:.1f} ms "
              f"host clock), steady median {med:.0f} tx/s over {STEADY_PASSES} (min "
              f"{rates[0]:.0f}, max "
              f"{rates[-1]:.0f}, spread {(rates[-1] - rates[0]) / med:.1%})  [{card}]")
        print(f"service (scheduler route, G8): every outcome == the oracle, {n / g8_s:.0f} tx/s;"
              f" stats {g8_stats}; launches {g8}  [{card}]")
        print(f"service (windowed route, window_s=0.005, {len(st_win.stxs)} transactions: "
              f"the composite signer held apart): every outcome == the oracle, "
              f"{len(st_win.stxs) / win_s:.0f} tx/s; stats {win_stats}; launches {win}  [{card}]")
        service_window_refused(dev, st, sync)
        if profiled:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _stats, prof_s = service_run(dev, st, sync, st.expected)
            busy_ms, device_us = device_busy(prof)
            print(f"service, profiled pass: {prof_s * 1e3:.1f} ms host clock, device busy "
                  f"{busy_ms:.2f} ms = {busy_ms / (prof_s * 1e3):.2%}; by name: "
                  + ", ".join(f"{k.split('(')[0]} {v / 1e3:.3f} ms"
                              for k, v in sorted(device_us.items(), key=lambda kv: -kv[1])[:8])
                  + f"  [{card}]")
        stages = service_stage_times(dev, st, sync)
        per = {k: v * 1e3 / max(stages["batches"], 1) for k, v in stages.items()
               if k not in ("batches", "pass")}
        print(f"service, host ms a scheduler batch ({stages['batches']} batches in a pass of "
              f"its own, {stages['pass'] * 1e3:.1f} ms; summed over threads): flatten and "
              f"submit {per['submit']:.2f}, collect {per['collect']:.2f}, signer algebra "
              f"{per['algebra']:.2f}, contract run {per['contracts']:.2f}  [{card}]")
        serial = service_serial_times(st)
        print(f"service, host s on one thread over the {n} transactions (ids cold): ids and "
              f"signable bytes {serial['flatten']:.3f}, the {rows['bls']} BLS rows' verify "
              f"{serial['bls']:.3f}, contract run {serial['contracts']:.3f}  [{card}]")
        service_failed_dispatch(dev, st, sync)
        service_filtered(st)
    finally:
        set_attachment_fetcher(None)
        shutdown_scheduler()
    return {"launches": b8, "stream": st, "rate": med}


FLOW_RECEIVERS = 16    # phase 18d: receivers resolving at once
FLOW_HOPS_EACH = 64    # phase 18d: each one's chain
FLOW_PEERS: dict = {}  # phase 18's parties by name, for its flows
_FLOWS: dict = {}


def flow_classes():
    """Phase 18's flows, made once and bound at module level (a parked
    flow is rebuilt from its class path): ``ChipFetchTip`` asks a peer for
    one transaction and receives it with ``ReceiveTransactionFlow(record=
    True)``, which resolves its back-chain; the peer's ``ChipVendTip``
    answers with ``SendTransactionFlow`` for it; ``ChipProbeTip`` receives
    the transaction and then asks the vendor for another id."""
    import dataclasses
    import types

    if _FLOWS:
        return types.SimpleNamespace(**_FLOWS)
    from corda_tpu_torch.crypto import SecureHash
    from corda_tpu_torch.flows import (
        FetchRequest,
        FlowLogic,
        InitiatedBy,
        ReceiveTransactionFlow,
        SendTransactionFlow,
    )

    @dataclasses.dataclass
    class ChipFetchTip(FlowLogic):
        peer: str
        tip: bytes

        def call(self):
            s = self.initiate_flow(FLOW_PEERS[self.peer])
            s.send(SecureHash(self.tip))
            return self.sub_flow(ReceiveTransactionFlow(s, record=True))

    @dataclasses.dataclass
    class ChipProbeTip(FlowLogic):
        peer: str
        tip: bytes
        probe: bytes

        def call(self):
            s = self.initiate_flow(FLOW_PEERS[self.peer])
            s.send(SecureHash(self.tip))
            s.receive()
            s.send_and_receive(list, FetchRequest("tx", (SecureHash(self.probe),)))

    class ChipVendTip(FlowLogic):
        def __init__(self, session):
            self.session = session

        def call(self):
            h = self.session.receive(SecureHash).unwrap(lambda x: x)
            stx = self.services.validated_transactions.get(h)
            self.sub_flow(SendTransactionFlow(self.session, stx))

    class ChipVendProbed(ChipVendTip):
        pass

    for cls in (ChipFetchTip, ChipProbeTip, ChipVendTip, ChipVendProbed):
        cls.__qualname__ = cls.__name__
        globals()[cls.__name__] = _FLOWS[cls.__name__] = cls
    InitiatedBy(ChipFetchTip)(ChipVendTip)
    InitiatedBy(ChipProbeTip)(ChipVendProbed)
    return types.SimpleNamespace(**_FLOWS)


class FlowNet:
    """Phase 18's nodes: one ``MockNetworkNodes`` on the card with a sender
    that holds the transactions; ``receiver`` makes a fresh node (ids cold,
    empty storage and vault) whose key is ``keypair``."""

    def __init__(self, dev, stxs):
        from corda_tpu_torch.testing.mocknet import MockNetworkNodes

        self.net = MockNetworkNodes(device=dev)
        self.sender = self.net.create_node("Vendor")
        for stx in stxs:
            self.sender.services.validated_transactions.add_transaction(stx)
        self.n = 0
        FLOW_PEERS.update(self.net.parties)

    def receiver(self, keypair, tier=None):
        self.n += 1
        node = self.net.create_node(f"Receiver {self.n}", keypair=keypair, tier=tier)
        FLOW_PEERS.update(self.net.parties)
        node.recorded = []
        node.services.validated_transactions.track(
            lambda stx, rec=node.recorded: rec.append(stx.id))
        return node

    def fetch(self, node, tip, timeout=900):
        """``node`` resolves ``tip`` from the sender: (result, seconds, the
        parks of (the receiver's flow, the sender's), from their engines'
        counts). A flow parks when a wait outlives the grace; it resumes
        by replaying its op log."""
        flows = flow_classes()
        parks0 = (node.smm.parks, self.sender.smm.parks)
        t0 = time.perf_counter()
        res = node.run_flow(flows.ChipFetchTip(str(self.sender.party.name), tip.id.bytes),
                            timeout=timeout)
        secs = time.perf_counter() - t0
        return res, secs, (node.smm.parks - parks0[0], self.sender.smm.parks - parks0[1])

    def swap_row(self, tx_id, raw):
        """Store other bytes under ``tx_id`` (a lying sender); returns the
        bytes that were there."""
        db = self.sender.services.validated_transactions._db
        (old,) = db.execute("SELECT blob FROM transactions WHERE tx_id=?",
                            (tx_id.bytes,)).fetchone()
        db.execute("UPDATE transactions SET blob=? WHERE tx_id=?", (raw, tx_id.bytes))
        db.commit()
        return old

    def stop(self):
        self.net.stop()


def vault_view(node) -> tuple:
    """A receiver vault's (unconsumed, consumed) state refs, sorted."""
    from corda_tpu_torch.node import QueryCriteria, StateStatus

    v = node.services.vault_service
    consumed = v.query_by(QueryCriteria(status=StateStatus.CONSUMED)).states
    return (sorted((s.ref.txhash.bytes, s.ref.index) for s in v.unconsumed_states()),
            sorted((s.ref.txhash.bytes, s.ref.index) for s in consumed))


def fetch_order(tip, by_id) -> dict:
    """The tip's back-chain in the order a fresh receiver's
    ``ResolveTransactionsFlow`` fetches it (breadth first from the tip,
    each round's ids sorted by their bytes): the dict the flow verifies,
    whose order sets the order within each level."""
    out: dict = {}
    frontier = sorted({ref.txhash for ref in tip.inputs}, key=lambda h: h.bytes)
    while frontier:
        for h in frontier:
            out[h] = by_id[h]
        frontier = sorted({ref.txhash for h in frontier for ref in by_id[h].inputs
                           if ref.txhash not in out}, key=lambda h: h.bytes)
    return out


def check_fetch(node, res, tip, want_order) -> None:
    """A resolve through the flow: the tip back, recorded deps-first in
    ``want_order`` then the tip, the vault left with the tip's output
    only."""
    from corda_tpu_torch.serialization import serialize

    if serialize(res) != serialize(tip):
        raise AssertionError("the flow's result is not the tip")
    if node.recorded != list(want_order) + [tip.id]:
        raise AssertionError(f"recorded order differs ({len(node.recorded)} recorded, "
                             f"{len(want_order) + 1} wanted)")
    unconsumed, consumed = vault_view(node)
    if unconsumed != [(tip.id.bytes, 0)]:
        raise AssertionError(f"the receiver's vault holds {len(unconsumed)} unconsumed states")
    if not consumed:
        raise AssertionError("the receiver's vault recorded no spent state")


class FlowStages:
    """Host seconds by stage while it is entered: the fetch rounds
    (``send_and_receive`` of the resolve, its replays after a park
    included), ``verify_transaction_dag`` and ``record_transactions``, each
    wrapped with a timer and put back on exit; the top-level check from
    the ``flow.verify_stx`` spans that the tracer, sampling every flow
    while it is entered, records."""

    def __init__(self):
        import corda_tpu_torch.parallel as parallel
        from corda_tpu_torch.flows import FlowSession
        from corda_tpu_torch.node import ServiceHub
        from corda_tpu_torch.observability import tracer

        self.stages = {"rounds": (FlowSession, "send_and_receive"),
                       "verify_dag": (parallel, "verify_transaction_dag"),
                       "record": (ServiceHub, "record_transactions")}
        self.acc = {k: [] for k in self.stages}
        self.originals = {k: getattr(owner, name)
                          for k, (owner, name) in self.stages.items()}
        self.tracer = tracer()
        self.spans = []

    def __enter__(self):
        for k, (owner, name) in self.stages.items():
            setattr(owner, name, timed(self.originals[k], self.acc[k]))
        self.tracer.clear()
        self.tracer.configure(sample_rate=1.0)
        return self

    def __exit__(self, *exc):
        for k, (owner, name) in self.stages.items():
            setattr(owner, name, self.originals[k])
        self.tracer.configure(sample_rate=0.0)
        self.spans = verify_spans(self.tracer)
        return False

    def seconds(self, k) -> float:
        if k == "top_check":
            return sum(sp["duration_s"] for sp in self.spans)
        return sum(self.acc[k])


def verify_spans(trc) -> list:
    """The tracer's finished ``flow.verify_stx`` spans (the top-level
    checks), emptying its store."""
    from corda_tpu_torch.observability import SPAN_FLOW_VERIFY

    spans = [sp for sp in trc.dump() if sp["name"] == SPAN_FLOW_VERIFY]
    trc.clear()
    return spans


def notarised_double_spend(dev):
    """An issue, two moves of its one state and a tip spending both, each
    move signed by the owner and the notary: the tip's back-chain holds a
    double spend."""
    from corda_tpu_torch.finance import CASH_PROGRAM_ID, CashState, Move
    from corda_tpu_torch.ledger import Amount, PrivacySalt, SignedTransaction, TransactionBuilder
    from corda_tpu_torch.testing import _party, back_chain, sign_tx_ids

    (owner, okp), (notary, nkp) = _party(b"Chain Owner"), _party(b"Chain Notary")
    issue = back_chain(0, seed=18, device=dev)[0][0]
    token = issue.tx.outputs[0].data.amount.token

    def move(inputs, salt, amount=1000):
        b = TransactionBuilder(notary=notary)
        b.set_privacy_salt(PrivacySalt(bytes([salt]) * 32))
        for ref in inputs:
            b.add_input_state(ref)
        b.add_output_state(CashState(Amount(amount, token), owner), CASH_PROGRAM_ID)
        b.add_command(Move(), owner.owning_key)
        return b.to_wire_transaction()

    a, b = move([issue.tx.out_ref(0)], 1), move([issue.tx.out_ref(0)], 2)
    tip = move([a.out_ref(0), b.out_ref(0)], 3, amount=2000)
    sigs = sign_tx_ids([(kp, w.id) for w in (a, b, tip) for kp in (okp, nkp)], dev)
    return [issue] + [SignedTransaction.create(w, sigs[2 * i:2 * i + 2])
                      for i, w in enumerate((a, b, tip))]


def flow_failures(dev, fnet, chain, okp, sync) -> None:
    """Phase 18c: each failure kind fails the receiver's flow with the
    reference's error."""
    import dataclasses

    import corda_tpu_torch.node.services as node_services
    from corda_tpu_torch.flows import FlowException
    from corda_tpu_torch.parallel import DoubleSpendInDagError
    from corda_tpu_torch.serialization import serialize
    from corda_tpu_torch.serving import DeviceScheduler
    from corda_tpu_torch.verifier import InvalidSignatureError

    def expect(name, err_cls, run, message=None, node=None):
        try:
            run()
        except err_cls as e:
            if message is not None and str(e) != message:
                raise AssertionError(f"{name}: {type(e).__name__}: {e}") from e
            print(f"resolve flow failure on the card, {name}: {type(e).__name__}: "
                  f"{str(e)[:100]}")
            return
        raise AssertionError(f"{name}: the flow did not fail with {err_cls.__name__}")

    tip = chain[-1]
    # a sender that substitutes chain[-10]'s bytes for chain[-11]'s
    want = chain[-11]
    old = fnet.swap_row(want.id, serialize(chain[-10]))
    try:
        node = fnet.receiver(okp)
        expect("a substituted transaction", FlowException, lambda: fnet.fetch(node, tip),
               f"peer sent wrong transaction for {want.id}")
        if node.recorded:
            raise AssertionError("the receiver recorded part of a substituted chain")
    finally:
        fnet.swap_row(want.id, old)

    # a forged signature deep in the chain
    deep = chain[len(chain) // 2]
    sig = deep.sigs[0]
    forged = dataclasses.replace(deep, sigs=(dataclasses.replace(
        sig, signature=sig.signature[:11] + bytes([sig.signature[11] ^ 2])
        + sig.signature[12:]),) + deep.sigs[1:])
    old = fnet.swap_row(deep.id, serialize(forged))
    try:
        node = fnet.receiver(okp)
        expect("a forged signature deep in the chain", InvalidSignatureError,
               lambda: fnet.fetch(node, tip))
        if node.recorded:
            raise AssertionError("the receiver recorded part of a forged chain")
    finally:
        fnet.swap_row(deep.id, old)

    # a double spend inside the fetched DAG
    ds = notarised_double_spend(dev)
    for stx in ds:
        fnet.sender.services.validated_transactions.add_transaction(stx)
    node = fnet.receiver(okp)
    expect("a double spend inside the fetched DAG", DoubleSpendInDagError,
           lambda: fnet.fetch(node, ds[-1]))

    # a vend probe for a transaction outside the chain being sent
    flows = flow_classes()
    node = fnet.receiver(okp)
    probe = ds[0].id
    expect("a vend probe outside the chain", FlowException,
           lambda: node.run_flow(flows.ChipProbeTip(str(fnet.sender.party.name),
                                                    tip.id.bytes, probe.bytes), timeout=120),
           f"transaction {probe} is not in the back-chain being sent")

    # a closed scheduler: the top-level check sheds to the host check, as the
    # reference's does, the flow completes and its span says so
    from corda_tpu_torch.observability import configure_tracing, tracer

    closed = DeviceScheduler(device=dev)
    closed.shutdown()
    shed_before = fallbacks()["verifier.host_shed"]
    real = node_services.device_scheduler
    node_services.device_scheduler = lambda *a, **k: closed
    configure_tracing(sample_rate=1.0)
    tracer().clear()
    try:
        node = fnet.receiver(okp)
        short = chain[8]
        fnet.fetch(node, short)
        if node.recorded != [s.id for s in chain[:9]]:
            raise AssertionError("the closed scheduler's receiver did not record the chain "
                                 "and its tip")
        shed = [sp["attrs"].get("degraded") for sp in tracer().dump()
                if sp["name"] == "flow.verify_stx"]
        if not shed or set(shed) != {"host-fallback"}:
            raise AssertionError(f"the closed scheduler's checks did not shed to the host: "
                                 f"{shed}")
        counted = fallbacks()["verifier.host_shed"] - shed_before
        if counted != len(shed):
            raise AssertionError(f"{len(shed)} sheds to the host but verifier.host_shed "
                                 f"counted {counted}")
        print(f"a closed scheduler: {len(shed)} top-level checks shed to the host check "
              f"(degraded=host-fallback, verifier.host_shed +{counted}), the flow completed")
    finally:
        node_services.device_scheduler = real
        configure_tracing(sample_rate=0.0)
        tracer().clear()


def concurrent_receivers(dev, card, sync, n=FLOW_RECEIVERS, hops=FLOW_HOPS_EACH) -> None:
    """Phase 18d: ``n`` receivers resolve ``n`` distinct ``hops``-hop chains
    at once from one sender; every outcome checked, and the scheduler's
    batches against its requests (its counters), the top-level checks
    apart (the batch each one's ``flow.verify_stx`` span names)."""
    from concurrent.futures import wait

    from corda_tpu_torch.observability import tracer
    from corda_tpu_torch.serving import device_scheduler
    from corda_tpu_torch.testing import _party, back_chain

    chains = [back_chain(hops, seed=1800 + i, device=dev, notarised=True)[0] for i in range(n)]
    okp = _party(b"Chain Owner")[1]
    fnet = FlowNet(dev, [stx for c in chains for stx in c])
    flows = flow_classes()
    trc = tracer()
    try:
        nodes = [fnet.receiver(okp) for _ in range(n)]
        sched = device_scheduler(dev)
        counts0 = dict(sched.counters)
        parks0 = fnet.sender.smm.parks
        trc.clear()
        trc.configure(sample_rate=1.0)
        sync()
        t0 = time.perf_counter()
        handles = [node.smm.start_flow(flows.ChipFetchTip(str(fnet.sender.party.name),
                                                          c[-1].id.bytes))
                   for node, c in zip(nodes, chains)]
        wait([h.result for h in handles], timeout=600)
        secs = time.perf_counter() - t0
        trc.configure(sample_rate=0.0)
        for node, c, h in zip(nodes, chains, handles):
            check_fetch(node, h.result.result(), c[-1], [s.id for s in c[:-1]])
        requests, batches = (sched.counters[k] - counts0[k]
                             for k in ("serving.requests", "serving.batches"))
        parks = (sum(node.smm.parks for node in nodes), fnet.sender.smm.parks - parks0)
    finally:
        trc.configure(sample_rate=0.0)
        fnet.stop()
    inter = [sp["attrs"].get("serving.batch") for sp in verify_spans(trc)]
    if len(inter) != n or None in inter:
        raise AssertionError(f"{len(inter)} top-level checks settled, {n} wanted")
    print(f"resolve flow, {n} receivers at once ({n} distinct {hops}-hop chains from one "
          f"sender): every outcome == its chain; {n * (hops + 1) / secs:.0f} resolved tx/s "
          f"together ({secs * 1e3:.1f} ms host clock); top-level checks (INTERACTIVE): {n} "
          f"requests in {len(set(inter))} scheduler batches; all the scheduler's requests: "
          f"{requests} in {batches} batches; parks: receivers {parks[0]}, sender "
          f"{parks[1]}  [{card}]")


def resolve_flow_phase(dev, card, hops=RESOLVE_HOPS, n_gen=FLOW_GEN_TXS, sync=None,
                       profiled=True) -> dict:
    """Phase 18: the resolve flow between two nodes on the card
    (BASELINE config #4 as the flow runs it). Returns the launches of the
    first pass of (a). Every pass prints its flows' parks."""
    import statistics

    import torch

    from corda_tpu_torch.ops.ed25519 import Ed25519Tier
    from corda_tpu_torch.ops.ed25519_ladder import ed25519_verify_ladder, ed25519_verify_ladder_w4
    from corda_tpu_torch.ops.ed25519_ladder4096 import ed25519_verify_g4, ed25519_verify_g8
    from corda_tpu_torch.ops.ed25519_sign import ed25519_comb
    from corda_tpu_torch.ops.scalar25519 import ed25519_challenge
    from corda_tpu_torch.ops.sha256 import sha256_leaves, sha256_merkle_sweep
    from corda_tpu_torch.parallel import verify_transaction_dag
    from corda_tpu_torch.serving import shutdown_scheduler
    from corda_tpu_torch.testing import GeneratedLedger, _party, back_chain, dag_tip
    from corda_tpu_torch.testing.mocknet import MOCK_PARKING_GRACE_S

    sync = sync or torch.cuda.synchronize
    kernels = (ed25519_challenge, sha256_leaves, sha256_merkle_sweep, ed25519_comb,
               ed25519_verify_ladder, ed25519_verify_ladder_w4, ed25519_verify_g8,
               ed25519_verify_g4)

    def launches_of(fn):
        for k in kernels:
            k.launches = 0
        out = fn()
        return {k.__name__: k.launches for k in kernels}, out

    def require(launches, must, label):
        if min(launches[k] for k in must) == 0 or any(
                v for k, v in launches.items() if k not in must):
            raise AssertionError(f"{label}: launches {launches}")

    flow_classes()
    t0 = time.perf_counter()
    chain, _notary = back_chain(hops, seed=20261018, device=dev, notarised=True)
    okp = _party(b"Chain Owner")[1]
    tip = chain[-1]
    fnet = FlowNet(dev, chain)
    print(f"resolve flow: a {hops}-hop notarised chain ({len(chain)} transactions, "
          f"{sum(len(s.sigs) for s in chain)} signatures) built and stored on the sender in "
          f"{time.perf_counter() - t0:.1f} s (signed on the card); the mock network's "
          f"parking grace {MOCK_PARKING_GRACE_S} s")
    try:
        # (a) the chain through ReceiveTransactionFlow -> ResolveTransactionsFlow
        dag = fetch_order(tip, {stx.id: stx for stx in chain})
        cold_ids(dag.values())
        direct = verify_transaction_dag(dag, device=dev).order
        cold_ids(dag.values())
        t0 = time.perf_counter()
        host = verify_transaction_dag(dag, device=dev, use_device=False).order
        host_s = time.perf_counter() - t0
        if direct != host or len(direct) != hops:
            raise AssertionError("the direct resolve differs from the host route's")
        must = ("ed25519_challenge", "sha256_leaves", "sha256_merkle_sweep",
                "ed25519_verify_ladder")
        node = fnet.receiver(okp)
        sync()
        with FlowStages() as stages:
            launches, (res, first_s, first_parks) = launches_of(lambda: fnet.fetch(node, tip))
        require(launches, must, "resolve flow on B8")
        check_fetch(node, res, tip, direct)
        steady, steady_parks = [], []
        for _ in range(STEADY_PASSES):
            node = fnet.receiver(okp)
            sync()
            res, secs, parks = fnet.fetch(node, tip)
            check_fetch(node, res, tip, direct)
            steady.append(secs)
            steady_parks.append(parks)
        n = len(chain)
        rates = sorted(n / s for s in steady)
        med = statistics.median(rates)
        print(f"resolve flow (BASELINE config #4): a fresh receiver runs "
              f"ReceiveTransactionFlow(record=True) against the sender's SendTransactionFlow "
              f"for the tip; {n} transactions recorded deps-first == the direct "
              f"verify_transaction_dag's order == the host route's ({host_s:.2f} s), the vault "
              f"left with the tip's output, {hops} outputs spent; launches {launches}")
        print(f"resolve flow: first pass {n / first_s:.0f} resolved tx/s ({first_s * 1e3:.1f} "
              f"ms host clock), steady median {med:.0f} tx/s over {STEADY_PASSES} (min "
              f"{rates[0]:.0f}, max {rates[-1]:.0f}, spread {(rates[-1] - rates[0]) / med:.1%}); "
              f"parks (receiver, sender): first {first_parks}, steady {steady_parks}  [{card}]")
        rounds = stages.seconds("rounds")
        print(f"resolve flow, host ms of the first pass by stage ({first_s * 1e3:.1f} ms): "
              f"{hops} fetch rounds {rounds * 1e3:.1f} ({rounds * 1e3 / hops:.3f} a round; "
              f"{len(stages.acc['rounds'])} calls with the replays), verify_transaction_dag "
              f"{stages.seconds('verify_dag') * 1e3:.1f}, record_transactions "
              f"{stages.seconds('record') * 1e3:.1f}, the top-level check "
              f"{stages.seconds('top_check') * 1e3:.2f}  [{card}]")
        if profiled:
            from torch.profiler import ProfilerActivity, profile

            # the card's activity only: the busy share needs no more, and
            # tracing the host's operators slows every fetch round
            node = fnet.receiver(okp)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                sync()
                res, prof_s, parks = fnet.fetch(node, tip)
                sync()
            check_fetch(node, res, tip, direct)
            busy_ms, device_us = device_busy(prof)
            print(f"resolve flow, profiled pass: {prof_s * 1e3:.1f} ms host clock (parks "
                  f"{parks}), device busy "
                  f"{busy_ms:.2f} ms = {busy_ms / (prof_s * 1e3):.2%}; by name: "
                  + ", ".join(f"{k.split('(')[0]} {v / 1e3:.3f} ms"
                              for k, v in sorted(device_us.items(), key=lambda kv: -kv[1])[:8])
                  + f"  [{card}]")

        # (b) a generated DAG under one tip, on B8 and on a G8 hub
        t0 = time.perf_counter()
        gen = GeneratedLedger(seed=20261018, n_parties=GEN_PARTIES, device=dev)
        gtxs = list(gen.generate(n_gen).values())
        gtip = dag_tip(gen)
        gkp = gen.keypairs[gen.parties[0].owning_key]
        gnet = FlowNet(dev, gtxs + [gtip])
        gdag = fetch_order(gtip, {stx.id: stx for stx in gtxs})
        cold_ids(gdag.values())
        g_direct = verify_transaction_dag(gdag, device=dev).order
        print(f"resolve flow, generated DAG: {len(gtxs)} transactions and a tip spending the "
              f"{len(gtip.inputs)} states they left, built in {time.perf_counter() - t0:.1f} s")
        try:
            outcomes = {}
            for tier, ladder in ((Ed25519Tier(), "ed25519_verify_ladder"),
                                 (Ed25519Tier(4096, 8), "ed25519_verify_g8")):
                gnode = gnet.receiver(gkp, tier=tier)
                sync()
                g_launches, (gres, g_s, g_parks) = launches_of(lambda: gnet.fetch(gnode, gtip))
                require(g_launches, must[:3] + (ladder,), f"generated DAG on {tier}")
                check_fetch(gnode, gres, gtip, g_direct)
                outcomes[tier] = (gnode.recorded, vault_view(gnode))
                print(f"resolve flow, generated DAG on {tier}: {len(gtxs) + 1} transactions "
                      f"recorded == the direct resolve's order; {len(gtxs) + 1} / {g_s:.2f} s "
                      f"= {(len(gtxs) + 1) / g_s:.0f} resolved tx/s; parks {g_parks}; launches "
                      f"{g_launches}"
                      f"  [{card}]")
            if len(set(map(repr, outcomes.values()))) != 1:
                raise AssertionError("the B8 and G8 receivers' outcomes differ")
            print("resolve flow, generated DAG: the B8 and G8 receivers' recorded order and "
                  "vaults are equal")
        finally:
            gnet.stop()

        # (c) each failure kind
        flow_failures(dev, fnet, chain, okp, sync)
    finally:
        fnet.stop()
    # (d) receivers at once
    try:
        concurrent_receivers(dev, card, sync)
    finally:
        shutdown_scheduler()
    return launches


STORM_INJECTORS = 8       # phase 19a: bench.py's bench_notary_loadtest, 8 injectors
STORM_CHUNK = 128         # of 128-transaction chunks,
STORM_WINDOW_S = 0.005    # into a window of 5 ms (max_batch NOTARY_WINDOW)
STORM_HOST_SAMPLE = 128   # moves the host tier answers beside the adversarial requests
STORM_SEQUENTIAL = 256    # moves through the sequential ValidatingNotaryService
STORM_RESUBMIT = 128      # fresh copies resubmitted from the cache, and evicted ones
STORM_BURST = (16, 256)   # a burst of 16 windows of 256
FINALITY_PARTIES = 4      # phase 19b: four parties and a notary node
FINALITY_INJECTORS = 8
FINALITY_GENERATIONS = 8   # 8 x 8 = 64 issue-and-move pairs (32 generations took 131 s)


class StormNotary:
    """A notary as the storm sees it: every request, its future, and the
    host-clock times it was submitted and answered, in submission order.
    With ``slo`` (an SLO monitor) each answer's latency is observed under
    the SERVICE class as it lands (a refusal as an error)."""

    def __init__(self, svc, slo=None):
        self.svc = svc
        self.uniqueness = svc.uniqueness
        self.lock = threading.Lock()
        self.requests, self.futures, self.t_submit = [], [], []
        self.t_done = {}
        self.slo = slo

    def request(self, stx, resolve, caller):
        t0 = time.perf_counter()
        fut = self.svc.request(stx, resolve, caller)

        def done(f):
            t1 = time.perf_counter()
            self.t_done[id(f)] = t1
            if self.slo is not None:
                self.slo.observe("service", t1 - t0, error=f.exception() is not None)

        fut.add_done_callback(done)
        with self.lock:
            self.requests.append(stx)
            self.futures.append(fut)
            self.t_submit.append(t0)
        return fut

    def latencies_ms(self) -> list:
        return sorted((self.t_done[id(f)] - t) * 1e3 for f, t in zip(self.futures, self.t_submit))


def settled(futures, timeout=300) -> list:
    """Each future's signature, or the error it was refused with."""
    out = []
    for f in futures:
        try:
            out.append(f.result(timeout=timeout))
        except Exception as e:  # a refusal is the request's answer
            out.append(e)
    return out


def storm_answer(result) -> tuple:
    """A notary answer as comparable data, the conflict's details with it."""
    conflict = getattr(result, "conflict", None)
    details = None if conflict is None else sorted(
        (ref.txhash.bytes, ref.index, d.consuming_tx.bytes, d.input_index,
         d.requesting_party_name) for ref, d in conflict.state_history.items())
    return answer_of(result), details


def storm_test(notary: StormNotary, stxs, resolve, commits: dict):
    """``tools.loadtest.notary_service_storm_test`` over a stream that holds
    requests the notary refuses (``commits``: object id -> whether the
    request commits). Its model counts the requests submitted; the gather
    waits for every future (a refusal is an answer) and reads the committed
    count plus the refusals expected among the submitted, which reconciles
    only if exactly the expected requests committed."""
    import dataclasses

    from corda_tpu_torch.tools.loadtest import notary_service_storm_test

    test = notary_service_storm_test(notary, stxs, resolve, chunk=STORM_CHUNK)

    def gather():
        settled(notary.futures)
        refused = sum(not commits[id(stx)] for stx in notary.requests)
        return notary.uniqueness.committed_txs() + refused

    return dataclasses.replace(test, gather=gather)


def storm_pass(dev, stream, stxs, resolve, commits, sync, tier=None, stages=None,
               windows=None, profiler=None, provider=None, committed=None, slo=None):
    """One storm pass over ``stxs`` (ids cold) into a fresh
    ``BatchedNotaryService`` on ``dev`` with ``provider`` (a fresh
    ``PersistentUniquenessProvider`` by default): (the notary, the
    runner's metrics, seconds). ``stages`` collects the host seconds of
    each stage a window, ``windows`` each window's size; ``committed``
    (with a ``committed_txs()``) counts the commits where the provider
    cannot; ``slo`` observes every answer's latency."""
    from corda_tpu_torch.notary import BatchedNotaryService, PersistentUniquenessProvider
    from corda_tpu_torch.tools.loadtest import LoadTestRunner, RunParameters

    cold_ids(stxs)
    svc = BatchedNotaryService(stream.notary, stream.notary_keypair,
                               provider or PersistentUniquenessProvider(),
                               max_batch=NOTARY_WINDOW, window_s=STORM_WINDOW_S, device=dev,
                               tier=tier)
    if stages is not None:
        for name in ("dispatch_ids", "dispatch_batch", "settle_validate", "settle_sign",
                     "finalize_batch"):
            setattr(svc, name, timed(getattr(svc, name), stages.setdefault(name, [])))
    take = svc._take_window

    def take_window():
        t0 = time.perf_counter()
        batch, stopped = take()
        if batch:  # the flusher polls every window_s: empty takes are not windows
            if stages is not None:
                stages.setdefault("take", []).append(time.perf_counter() - t0)
            if windows is not None:
                windows.append(len(batch))
        return batch, stopped

    svc._take_window = take_window
    notary = StormNotary(svc, slo)
    if committed is not None:
        notary.uniqueness = committed
    params = RunParameters(parallelism=STORM_INJECTORS,
                           generate_count=len(stxs) // (STORM_INJECTORS * STORM_CHUNK),
                           execution_frequency_hz=None, gather_frequency=10**9)
    runner = LoadTestRunner(storm_test(notary, stxs, resolve, commits), params)
    sync()
    t0 = time.perf_counter()
    if profiler is None:
        metrics = runner.run()
    else:
        with profiler:
            metrics = runner.run()
    sync()
    return notary, metrics, time.perf_counter() - t0


def check_storm(notary: StormNotary, kinds: dict, dev) -> list:
    """Every answer of the storm is its request's expected kind, and every
    signature verifies through the port's verify path on the card.
    Returns the answers in submission order."""
    from corda_tpu_torch.testing import outcome_kind
    from corda_tpu_torch.verifier import verify_signature_rows

    answers = settled(notary.futures)
    got = [outcome_kind(r) for r in answers]
    want = [kinds[id(stx)] for stx in notary.requests]
    if got != want:
        bad = [(i, g, w) for i, (g, w) in enumerate(zip(got, want)) if g != w]
        raise AssertionError(f"storm answers differ (slot, got, want): {bad[:10]}")
    rows = [(r.by, r.signature, r.signable_for(stx.id))
            for stx, r, k in zip(notary.requests, answers, got) if k == "signed"]
    if not verify_signature_rows(rows, device=dev).all():
        raise AssertionError("a storm signature fails the port's verify path")
    return answers


def storm_phase(dev, card, n_moves=NOTARY_TXS, window=NOTARY_WINDOW, sync=None,
                profiled=True, stream=None) -> dict:
    """Phase 19a: ``tools.loadtest``'s notary-service storm (bench.py's
    ``bench_notary_loadtest`` shape) against ``BatchedNotaryService.request``
    on the card, over ``stream`` (phase 8's, or built here). Returns the
    first pass's launches."""
    import statistics
    import sys as _sys

    import torch

    from corda_tpu_torch.ledger import ComponentGroupType
    from corda_tpu_torch.notary import (
        BatchedNotaryService,
        PersistentUniquenessProvider,
        ValidatingNotaryService,
    )
    from corda_tpu_torch.ops.ed25519 import Ed25519Tier
    from corda_tpu_torch.serialization import deserialize, serialize
    from corda_tpu_torch.testing import notary_stream, outcome_kind, state_resolver

    sync = sync or torch.cuda.synchronize
    kernels = phase_kernels()

    def launches_of(fn):
        for k in kernels:
            k.launches = 0
        out = fn()
        return {k.__name__: k.launches for k in kernels}, out

    t0 = time.perf_counter()
    built = stream is None
    if built:
        stream = notary_stream(n_moves, window, seed=20261017, contract_invalid=True,
                               device=dev)
    stxs = [stx for w in stream.windows for stx in w]
    n_moves = len(stxs) - sum(k != "signed" for w in stream.kinds for k in w)
    for stx in stxs:
        for g in ComponentGroupType:
            stx.tx.component_bytes(g)
    kinds = {id(stx): k for stx, k in zip(stxs, (k for w in stream.kinds for k in w))}
    commits = {i: k == "signed" for i, k in kinds.items()}
    resolve = state_resolver(stream.issue.tx)
    per_pass = len(stxs) // (STORM_INJECTORS * STORM_CHUNK) * STORM_INJECTORS * STORM_CHUNK
    n_signed = sum(commits[id(stx)] for stx in stxs[:per_pass])
    print(f"notary storm: {len(stxs)} requests ({n_moves} moves and {len(stxs) - n_moves} "
          f"adversarial), " + (f"built and signed on the card in {time.perf_counter() - t0:.1f} s"
                               if built else "phase 8's stream") + "; "
          f"each pass submits the first {per_pass} from {STORM_INJECTORS} injectors in chunks "
          f"of {STORM_CHUNK} into a validating BatchedNotaryService (max_batch {window}, "
          f"window_s {STORM_WINDOW_S}, PersistentUniquenessProvider, tier B8); the model "
          f"expects {n_signed} to commit")
    try:
        storm_pass(dev, stream, stxs[: 2 * window], resolve, commits, sync)[0].svc.shutdown()

        # the first pass: launches, windows, latency, and each stage's host
        # time (host-clock reads around each call); its steady rate is phase
        # 25a's pass with every layer off (the script's time)
        windows: list = []
        stages: dict = {}
        launches, (first, metrics, first_s) = launches_of(
            lambda: storm_pass(dev, stream, stxs, resolve, commits, sync, windows=windows,
                               stages=stages))
        answers = check_storm(first, kinds, dev)
        if metrics["failed"] or metrics["final_state"] != per_pass:
            raise AssertionError(f"the storm's runner: {metrics}")
        if first.uniqueness.committed_txs() != n_signed:
            raise AssertionError(f"{first.uniqueness.committed_txs()} committed, "
                                 f"{n_signed} expected")
        must = ("ed25519_challenge", "ed25519_verify_ladder", "sha256_leaves",
                "sha256_merkle_sweep", "ed25519_comb")
        if min(launches[k] for k in must) == 0 or any(
                v for k, v in launches.items() if k not in must):
            raise AssertionError(f"the storm's launches: {launches}")
        lat = first.latencies_ms()
        print(f"notary storm, first pass: every answer its request's kind, every signature "
              f"verified on the card, {n_signed} committed == the model; launches {launches}")
        print(f"notary storm, first pass: {n_signed} notarised in {first_s * 1e3:.1f} ms "
              f"(host clock) = {n_signed / first_s:.0f} notarised tx/s ({per_pass / first_s:.0f} "
              f"requests/s); {len(windows)} windows, sizes min {min(windows)} median "
              f"{statistics.median(windows):.0f} max {max(windows)}; request->result latency "
              f"p50 {lat[len(lat) // 2]:.1f} ms, p99 {lat[int(len(lat) * 0.99)]:.1f} ms  [{card}]")

        # the host tier (use_device=False) over a sample in stream order: the
        # adversarial requests, the moves they double-spend, and a stride of
        # moves; each answer must equal the storm's
        by_id = {id(stx): r for stx, r in zip(first.requests, answers)}
        submitted = stxs[:per_pass]
        stride = max(1, per_pass // STORM_HOST_SAMPLE)
        pick = sorted({i for i, stx in enumerate(submitted) if not commits[id(stx)]}
                      | {0, 1} | set(range(0, per_pass, stride)))
        host = BatchedNotaryService(stream.notary, stream.notary_keypair,
                                    PersistentUniquenessProvider(), max_batch=len(pick),
                                    use_device=False, device=dev)
        t0 = time.perf_counter()
        host_out = host.process_batch([(deserialize(serialize(submitted[i])), resolve,
                                        "loadtest") for i in pick])
        host_s = time.perf_counter() - t0
        for i, h in zip(pick, host_out):
            if storm_answer(h) != storm_answer(by_id[id(submitted[i])]):
                raise AssertionError(f"request {i}: the storm's answer != the host tier's: "
                                     f"{storm_answer(by_id[id(submitted[i])])} != "
                                     f"{storm_answer(h)}")
        print(f"notary storm: {len(pick)} requests (every adversarial one, the moves they "
              f"double-spend, every {stride}th) answered by the host tier in {host_s:.1f} s "
              f"(pure-Python ed25519): signature bytes and conflicts == the storm's")

        # resubmissions: (i) every accepted request the cache still holds
        # (the reference's bound, SIGNED_CACHE_MAX, keeps the newer half), at
        # the door; (ii) fresh copies of some (ids cold), after their window's
        # id sweep; neither signs nor commits. (iii) Fresh copies of evicted
        # ones take the whole path again and get the same bytes.
        svc = first.svc
        accepted = [(stx, r) for stx, r in zip(first.requests, answers)
                    if outcome_kind(r) == "signed"]
        cached = [(stx, r) for stx, r in accepted if svc.cached_signature(stx.id) is not None]
        evicted = [(stx, r) for stx, r in accepted if svc.cached_signature(stx.id) is None]
        committed0 = svc.uniqueness.committed_txs()
        ed25519_comb = next(k for k in kernels if k.__name__ == "ed25519_comb")
        ed25519_comb.launches = 0
        futs = [svc.request(stx, resolve, "retry") for stx, _r in cached]
        if not all(f.done() for f in futs):
            raise AssertionError("a cached resubmission was not answered at the door")
        fresh = [(deserialize(serialize(stx)), r) for stx, r in cached[:STORM_RESUBMIT]]
        futs += [svc.request(stx, resolve, "retry") for stx, _r in fresh]
        again = settled(futs)
        if [a.signature for a in again] != [r.signature for _s, r in cached + fresh]:
            raise AssertionError("a resubmission got other bytes than the original")
        if ed25519_comb.launches or svc.uniqueness.committed_txs() != committed0:
            raise AssertionError(f"resubmissions signed ({ed25519_comb.launches} launches of "
                                 "E) or committed")
        gone = [(deserialize(serialize(stx)), r) for stx, r in evicted[:STORM_RESUBMIT]]
        redo = settled([svc.request(stx, resolve, "retry") for stx, _r in gone])
        if [a.signature for a in redo] != [r.signature for _s, r in gone]:
            raise AssertionError("an evicted resubmission got other bytes than the original")
        if svc.uniqueness.committed_txs() != committed0:
            raise AssertionError("an evicted resubmission committed again")
        svc.shutdown()
        print(f"notary storm, resubmitted: {len(cached)} accepted requests the cache holds "
              f"(of {len(accepted)}; SIGNED_CACHE_MAX {svc.SIGNED_CACHE_MAX}) answered at the "
              f"door and {len(fresh)} fresh copies after their window's id sweep, the original "
              f"bytes, E launched 0 times, nothing committed; {len(gone)} evicted ones through "
              f"the whole path: the same bytes, nothing committed")

        # host ms a window of each stage, over the first pass: a window's
        # dispatch_batch calls dispatch_ids again, over ids already primed,
        # so each stage's total is shared out over the windows
        print(f"notary storm, host ms a window ({len(windows)} windows, {first_s * 1e3:.1f} ms "
              f"pass): " + ", ".join(
                  f"{name} {1e3 * sum(v) / len(windows):.2f} ({len(v)} calls)"
                  for name, v in stages.items())
              + f"  [{card}]")

        # the device's busy share, the card's activity only
        if profiled:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])
            notary, _m, prof_s = storm_pass(dev, stream, stxs, resolve, commits, sync,
                                            profiler=prof)
            check_storm(notary, kinds, dev)
            notary.svc.shutdown()
            busy_ms, device_us = device_busy(prof)
            print(f"notary storm, profiled pass: {prof_s * 1e3:.1f} ms host clock, device busy "
                  f"{busy_ms:.1f} ms = {busy_ms / (prof_s * 1e3):.2%}; by name: "
                  + ", ".join(f"{k.split('(')[0]} {v / 1e3:.2f} ms"
                              for k, v in sorted(device_us.items(), key=lambda kv: -kv[1])[:8])
                  + f"  [{card}]")

        # one pass on G8
        g_launches, (g_notary, _m, g_s) = launches_of(lambda: storm_pass(
            dev, stream, stxs, resolve, commits, sync, tier=Ed25519Tier(4096, 8)))
        g_answers = check_storm(g_notary, kinds, dev)
        g_notary.svc.shutdown()
        g_by_id = {id(stx): storm_answer(r) for stx, r in zip(g_notary.requests, g_answers)}
        if any(g_by_id[id(stx)] != storm_answer(r) for stx, r in zip(first.requests, answers)):
            raise AssertionError("the G8 storm's answers differ from B8's")
        if g_launches["ed25519_verify_g8"] == 0 or g_launches["ed25519_verify_ladder"]:
            raise AssertionError(f"the G8 storm's launches: {g_launches}")
        print(f"notary storm on G8: every answer == B8's; {n_signed / g_s:.0f} notarised tx/s; "
              f"launches {g_launches}  [{card}]")

        # a burst of 16 windows in flight at once
        n_win, per = STORM_BURST
        burst = stxs[: n_win * per]
        cold_ids(burst)
        svc = BatchedNotaryService(stream.notary, stream.notary_keypair,
                                   PersistentUniquenessProvider(), max_batch=per,
                                   window_s=STORM_WINDOW_S, device=dev)
        seen: list = []
        take = svc._take_window

        def take_window():
            batch, stopped = take()
            if batch:
                seen.append(len(batch))
            return batch, stopped

        svc._take_window = take_window
        before = _sys.getswitchinterval()
        _sys.setswitchinterval(5.0)
        try:
            futs = [svc.request(stx, resolve, "burst") for stx in burst]
        finally:
            _sys.setswitchinterval(before)
        got = [outcome_kind(r) for r in settled(futs)]
        svc.shutdown()
        if seen != [per] * n_win or got != [kinds[id(stx)] for stx in burst]:
            raise AssertionError(f"the burst: windows {seen}, answers wrong "
                                 f"{sum(g != kinds[id(s)] for g, s in zip(got, burst))}")
        print(f"notary storm: a burst of {len(burst)} requests flushed as {n_win} windows of "
              f"{per}, all in flight at once, every answer its kind")

        # beside them: process_stream over the same stream, and the sequential
        # host service (bench.py's baseline shape) over a cut of one window
        out, stream_s = notary_pass(dev, stream, stream.windows, sync=sync, validating=True)
        check_notary_results(out, stream, dev, oracle=False)
        n_stream = sum(outcome_kind(r) == "signed" for w in out for r in w)
        seq = ValidatingNotaryService(stream.notary, stream.notary_keypair,
                                      PersistentUniquenessProvider())
        moves = [deserialize(serialize(stx)) for stx in stream.windows[1]
                 if kinds[id(stx)] == "signed"][:STORM_SEQUENTIAL]
        t0 = time.perf_counter()
        for stx in moves:
            seq.process(stx, resolve, "bench")
        seq_s = time.perf_counter() - t0
        print(f"notary, beside the storm: process_stream (windows of {window}, depth "
              f"{NOTARY_DEPTH}, B8) {n_stream / stream_s:.0f} notarised tx/s; the sequential "
              f"ValidatingNotaryService.process over {len(moves)} moves of one window "
              f"{len(moves) / seq_s:.1f} tx/s (host signature checks and signing)  [{card}]")
    finally:
        from corda_tpu_torch.serving import shutdown_scheduler

        shutdown_scheduler()
    return launches


def phase_kernels() -> tuple:
    """Every kernel wrapper with a launch counter."""
    from corda_tpu_torch.ops.ed25519_ladder import ed25519_verify_ladder, ed25519_verify_ladder_w4
    from corda_tpu_torch.ops.ed25519_ladder4096 import ed25519_verify_g4, ed25519_verify_g8
    from corda_tpu_torch.ops.ed25519_sign import ed25519_comb
    from corda_tpu_torch.ops.scalar25519 import ed25519_challenge
    from corda_tpu_torch.ops.secp256_ladder import ecdsa_verify_k1, ecdsa_verify_r1
    from corda_tpu_torch.ops.sha256 import sha256_leaves, sha256_merkle_sweep
    from corda_tpu_torch.ops.sphincs_batch import sphincs_verify

    return (ed25519_challenge, ed25519_verify_ladder, ed25519_verify_ladder_w4,
            ed25519_verify_g8, ed25519_verify_g4, sha256_leaves, sha256_merkle_sweep,
            ed25519_comb, ecdsa_verify_k1, ecdsa_verify_r1, sphincs_verify,
            *statestore_kernels())


class PaymentParts:
    """Host seconds of a payment's parts while entered. The payer's side:
    its signature checks (``ServiceHub.verify_stx_signatures``), the
    notary round trip (``NotaryFlowClient.call``, from its signature check
    through the session to the validated response), the record after
    notarisation and each broadcast (``BroadcastTransactionFlow.call``,
    until the recipient's acknowledgement). The notary's resolve of the
    back-chain (its ``ResolveTransactionsFlow.call``). The recipient's
    resolve, top-level check and record inside the broadcast."""

    def __init__(self, payer_hub, notary_hub, recipient_hub):
        from corda_tpu_torch.flows import (
            BroadcastTransactionFlow,
            NotaryFlowClient,
            ResolveTransactionsFlow,
        )
        from corda_tpu_torch.node import ServiceHub

        parts = (
            ("payer's checks", ServiceHub, "verify_stx_signatures", payer_hub),
            ("notary round trip", NotaryFlowClient, "call", payer_hub),
            ("notary's resolve", ResolveTransactionsFlow, "call", notary_hub),
            ("record", ServiceHub, "record_transactions", payer_hub),
            ("broadcast", BroadcastTransactionFlow, "call", payer_hub),
            ("recipient's resolve", ResolveTransactionsFlow, "call", recipient_hub),
            ("recipient's check", ServiceHub, "verify_stx_signatures", recipient_hub),
            ("recipient's record", ServiceHub, "record_transactions", recipient_hub),
        )
        self.acc = {key: [] for key, *_rest in parts}
        self.originals = {(owner, name): getattr(owner, name) for _k, owner, name, _h in parts}
        self.parts = parts

    def __enter__(self):
        by_site: dict = {}
        for key, owner, name, hub in self.parts:
            by_site.setdefault((owner, name), []).append((hub, key))
        for (owner, name), keyed in by_site.items():
            fn = self.originals[(owner, name)]

            def wrapper(this, *args, fn=fn, keyed=keyed, **kwargs):
                hub = getattr(this, "services", this)  # a flow's hub, or the hub itself
                t0 = time.perf_counter()
                try:
                    return fn(this, *args, **kwargs)
                finally:
                    for want, key in keyed:
                        if hub is want:
                            self.acc[key].append(time.perf_counter() - t0)
            setattr(owner, name, wrapper)
        return self

    def __exit__(self, *exc):
        for (owner, name), fn in self.originals.items():
            setattr(owner, name, fn)
        return False


def finality_phase(dev, card, generations=FINALITY_GENERATIONS, sync=None) -> dict:
    """Phase 19b: ``tools.loadtest``'s notarisation storm between the
    nodes of a mock network on the card: issue-and-move pairs through
    ``CashIssueFlow`` and ``CashPaymentFlow`` (``FinalityFlow``, the notary
    flows, the broadcast), notarised by a ``BatchedNotaryService`` node on
    B8, under a stall of the network's deliveries. Returns the launches."""
    import dataclasses
    import threading as _threading

    import torch

    from corda_tpu_torch.finance import CASH_PROGRAM_ID, CashPaymentFlow, CashState, Move
    from corda_tpu_torch.flows import FinalityFlow, NotaryException
    from corda_tpu_torch.ledger import TransactionBuilder
    from corda_tpu_torch.node import QueryCriteria, StateStatus
    from corda_tpu_torch.testing.mocknet import MOCK_PARKING_GRACE_S, MockNetworkNodes
    from corda_tpu_torch.tools.loadtest import (
        Disruption,
        LoadTestRunner,
        RunParameters,
        notarisation_storm_test,
    )

    sync = sync or torch.cuda.synchronize
    kernels = phase_kernels()
    net = MockNetworkNodes(device=dev)
    try:
        parties = [net.create_node(f"Party {i + 1}") for i in range(FINALITY_PARTIES)]
        notary = net.create_notary_node("Notary", batched=True, max_batch=NOTARY_WINDOW,
                                        window_s=STORM_WINDOW_S)
        nodes = dict(net.nodes)
        test = notarisation_storm_test(nodes, notary.party)
        # the expected balance of every node: each pair pays its amount to
        # its receiver (the payer's issue and payment cancel out)
        expected = {name: 0 for name in nodes}
        interpret = test.interpret

        def interpret_and_pay(state, cmd):
            _src, dst, qty = cmd
            expected[dst] += qty
            return interpret(state, cmd)

        # one pair at a time a paying node: two of one node's payments at
        # once can find every coin soft-locked by the other, and selection
        # then fails at once (the reference's storm does the same at this
        # parallelism)
        locks = {name: _threading.Lock() for name in nodes}
        execute = test.execute

        def execute_one_a_node(cmd):
            with locks[cmd[0]]:
                execute(cmd)

        test = dataclasses.replace(test, interpret=interpret_and_pay,
                                   execute=execute_one_a_node)

        def stall():
            net.net.stop_pumping()
            _threading.Timer(0.1, net.net.start_pumping).start()
            return None

        runner = LoadTestRunner(
            test, RunParameters(parallelism=FINALITY_INJECTORS, generate_count=generations,
                                execution_frequency_hz=None, gather_frequency=10**9),
            disruptions=[Disruption("stall", stall, at_generation=1)])
        for k in kernels:
            k.launches = 0
        parks0 = {name: n.smm.parks for name, n in nodes.items()}
        sync()
        metrics = runner.run()
        sync()
        launches = {k.__name__: k.launches for k in kernels}
        n_pairs = FINALITY_INJECTORS * generations
        parks = {name: n.smm.parks - parks0[name] for name, n in nodes.items()}
        if metrics["failed"] or metrics["executed"] != n_pairs or metrics["final_state"] != n_pairs:
            raise AssertionError(f"the notarisation storm: {metrics}")
        committed = notary.services.notary_service.uniqueness.committed_txs()
        if committed != n_pairs:
            raise AssertionError(f"the notary committed {committed}, {n_pairs} moves made")
        balances = {name: sum(sr.state.data.amount.quantity
                              for sr in n.services.vault_service.unconsumed_states(CashState))
                    for name, n in nodes.items()}
        if balances != expected:
            raise AssertionError(f"vault balances {balances} != the model's {expected}")
        must = ("ed25519_challenge", "ed25519_verify_ladder", "sha256_leaves",
                "sha256_merkle_sweep", "ed25519_comb")
        if min(launches[k] for k in must) == 0 or any(
                v for k, v in launches.items() if k not in must):
            raise AssertionError(f"the notarisation storm's launches: {launches}")
        exec_s = metrics["walls"]["execute_s"]
        print(f"finality: {n_pairs} issue-and-move pairs from {FINALITY_INJECTORS} injectors "
              f"(one pair at a time a paying node) between {FINALITY_PARTIES} parties and the "
              f"notary node (batched, B8, window_s "
              f"{STORM_WINDOW_S}) under a 0.1 s stall: the model reconciles, {committed} "
              f"committed == the moves, every vault's balance == the model's; launches "
              f"{launches}")
        print(f"finality: {n_pairs / exec_s:.1f} finalised payments/s ({exec_s:.2f} s of "
              f"execution, each pair an issue and a payment); parks (grace "
              f"{MOCK_PARKING_GRACE_S} s) {parks}  [{card}]")

        # a deliberate double spend: a second move of a state already spent
        payer = parties[0]
        spent = payer.services.vault_service.query_by(
            QueryCriteria(status=StateStatus.CONSUMED, contract_state_types=(CashState,))).states
        if not spent:
            raise AssertionError("no spent Cash state to spend again")
        sar = spent[0]
        b = TransactionBuilder(notary=sar.state.notary)
        b.add_input_state(sar)
        b.add_output_state(sar.state.data, CASH_PROGRAM_ID)
        b.add_command(Move(), sar.state.data.owner.owning_key)
        stx = payer.services.sign_initial_transaction(b)
        try:
            payer.run_flow(FinalityFlow(stx), timeout=120)
        except NotaryException as e:
            print(f"finality: a second move of a spent state refused: {e}")
        else:
            raise AssertionError("a double spend was notarised")
        if notary.services.notary_service.uniqueness.committed_txs() != committed:
            raise AssertionError("the refused double spend committed")

        # three payments alone, by part, from the richest party
        import gc

        src = max(parties, key=lambda n: balances[next(k for k, v in nodes.items() if v is n)])
        dst = next(p for p in parties if p is not src)
        for _ in range(3):
            gen2 = gc.get_stats()[2]["collections"]
            parks0 = (src.smm.parks, dst.smm.parks, notary.smm.parks)
            with PaymentParts(src.services, notary.services, dst.services) as parts:
                t0 = time.perf_counter()
                src.run_flow(CashPaymentFlow(10, "GBP", dst.party), timeout=120)
                pay_s = time.perf_counter() - t0
            parks = (src.smm.parks - parks0[0], dst.smm.parks - parks0[1],
                     notary.smm.parks - parks0[2])
            print(f"finality, one payment alone: {pay_s * 1e3:.1f} ms host clock (full "
                  f"collections {gc.get_stats()[2]['collections'] - gen2}, parks of payer, "
                  f"recipient, notary {parks}); by part: "
                  + ", ".join(f"{k} {1e3 * sum(v):.1f} ms ({len(v)})"
                              for k, v in parts.acc.items()) + f"  [{card}]")
    finally:
        net.stop()
        from corda_tpu_torch.serving import shutdown_scheduler

        shutdown_scheduler()
    return launches


def notary_storm_phase(dev, card, sync=None, profiled=True, stream=None) -> dict:
    """Phase 19: 19a, the service storm (over phase 8's ``stream`` when
    given), then 19b, finality between nodes. Returns the launches of
    each."""
    t0 = time.perf_counter()
    storm = storm_phase(dev, card, sync=sync, profiled=profiled, stream=stream)
    t1 = time.perf_counter()
    finality = finality_phase(dev, card, sync=sync)
    print(f"phase 19: 19a {t1 - t0:.1f} s, 19b {time.perf_counter() - t1:.1f} s")
    return {"storm": storm, "finality": finality}


CLUSTER_RETRY_S = 10.0       # phase 20: bench.py's submit window of each Raft provider
CLUSTER_BFT_TIMEOUT_S = 30.0  # and its BFT client's quorum wait (bench.py :581, :640)
# the BFT replicas' suspicion timer: one 2,048-request slot holds the
# network's pump thread for about a second on the card's host (four
# replicas decode, apply and sign it), so the default 1 s indicts a live
# primary, and a view change under load can leave a lagging replica that
# the new view's null fill strands (the reference's BFT has no state
# transfer); 10 s, like bench.py's other timeouts, suspects a dead one
CLUSTER_VIEW_TIMEOUT_S = 10.0
# the Raft replicas' election timeout and heartbeat: make_cluster's
# co-located 0.15-0.3 s and 0.05 s elect again and again while one
# window's apply holds the pump thread for about a second (up to 11
# terms in four passes, and a window that found no leader within two
# submit windows), so the replicas take make_node_on_endpoint's timings,
# the reference's for a slow transport
CLUSTER_ELECTION_S = (1.0, 2.0)
CLUSTER_HEARTBEAT_S = 0.25
CLUSTER_STEADY = (1, 0)      # steady passes after the first: Raft, BFT (the script's time)
CLUSTER_FAULT_AFTER = 3      # the faults strike once the third window has committed,
CLUSTER_FAULT_WINDOWS = 5    # in passes over the stream's first five windows
CLUSTER_FAULT_RETRY_S = 3.0  # the Raft failover pass's submit window
CLUSTER_DEPTH = 3            # process_stream's depth, as phase 8's


def replica_map(provider):
    """A co-located Raft replica's in-memory state machine: the uniqueness
    map its snapshot-install hook closes over."""
    return provider.node._install_map_fn.__defaults__[0]


class ReplicaCount:
    """``committed_txs()`` of a Raft cluster (the provider offers none: its
    map sits on every replica): the most any replica's state machine has
    applied, since a replica applies only committed entries."""

    def __init__(self, providers):
        self.providers = providers

    def committed_txs(self) -> int:
        return max(replica_map(p).committed_txs() for p in self.providers)


class Cluster:
    """A notary cluster on an in-memory network of its own, pumping: the
    3-replica Raft cluster of bench.py's ``bench_notary_raft_cluster`` or
    the 4-replica BFT cluster (BLS keys, certificates) of its
    ``bench_notary_bft_cluster``, with bench.py's timeouts and the slower
    election and view timers above. ``provider`` is what the notary
    commits through (for Raft a follower when ``via_follower``, which
    forwards to the leader as a client would)."""

    def __init__(self, kind: str, tag: str, via_follower: bool = False,
                 retry_s: float = CLUSTER_RETRY_S):
        from corda_tpu_torch.messaging import InMemoryMessagingNetwork
        from corda_tpu_torch.notary import BFTUniquenessProvider, RaftUniquenessProvider

        self.kind = kind
        self.net = InMemoryMessagingNetwork()
        self.net.start_pumping()
        self.replicas = []
        self.rounds: list = []
        self.stopped: set = set()
        try:
            if kind == "raft":
                names = [f"{tag}-r{i}" for i in range(3)]
                for name in names:
                    self.replicas.append(RaftUniquenessProvider.make_node_on_endpoint(
                        name, names, self.net.create_node(name),
                        election_timeout_s=CLUSTER_ELECTION_S,
                        heartbeat_s=CLUSTER_HEARTBEAT_S))
                for p in self.replicas:
                    p._retry_s = retry_s
                    p.node.start()
                self.leader = self.wait_leader(self.replicas)
                self.provider = (next(p for p in self.replicas if p is not self.leader)
                                 if via_follower else self.leader)
            else:
                self.replicas, make_client = BFTUniquenessProvider.make_cluster(
                    4, self.net, view_timeout_s=CLUSTER_VIEW_TIMEOUT_S)
                self.provider = make_client(f"{tag}-client")
                self.provider.client._timeout_s = CLUSTER_BFT_TIMEOUT_S
        except BaseException:
            self.close()
            raise
        inner = self.provider.commit_batch_async

        def counted(requests):  # a window that commits nothing makes no round
            if requests:
                self.rounds.append(len(requests))
            return inner(requests)

        self.provider.commit_batch_async = counted

    @staticmethod
    def wait_leader(providers, timeout=10.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for p in providers:
                if p.node.role == "leader":
                    return p
            time.sleep(0.01)
        raise AssertionError("no raft leader elected")

    def live(self) -> list:
        return [r for r in self.replicas if self.name_of(r) not in self.stopped]

    def name_of(self, replica) -> str:
        return replica.node.name if self.kind == "raft" else replica.name

    def stop(self, replica) -> None:
        """Crash one replica: its threads stop and its endpoint drops
        everything."""
        (replica.close if self.kind == "raft" else replica.stop)()
        self.net.stop_node(self.name_of(replica))
        self.stopped.add(self.name_of(replica))

    def elections(self) -> int:
        """Raft: the highest term; BFT: the highest view."""
        if self.kind == "raft":
            return max(p.node.current_term for p in self.replicas)
        return max(r.view for r in self.replicas)

    def digests(self, timeout=30.0) -> list:
        """Every live replica's consumed-set digest, once each has applied
        every round. A Raft leader elected mid-stream commits the entries
        of an earlier term only with one of its own (Raft's rule; the
        reference's leader appends no entry when elected), so after the
        last window an empty batch, a no-op for the state machine, goes
        through the provider first."""
        from corda_tpu_torch.serialization import serialize

        live = self.live()
        deadline = time.monotonic() + timeout
        if self.kind == "raft":
            self.provider._submit_retrying(serialize(("batch", [])))
            leader = self.wait_leader(live)
            done = lambda: all(p.node.last_applied >= leader.node.commit_index  # noqa: E731
                               for p in live)
        else:
            done = lambda: all(r._next_exec >= len(self.rounds) for r in live)  # noqa: E731
        while not done():
            if time.monotonic() > deadline:
                raise AssertionError(f"the {self.kind} replicas did not apply every round "
                                     f"({len(self.rounds)}): {self.state()}")
            time.sleep(0.01)
        return [(replica_map(p) if self.kind == "raft" else p.base).consumed_digest()
                for p in live]

    def state(self) -> list:
        """Each replica's protocol state, for a failure's message."""
        if self.kind == "raft":
            return [(p.node.name, p.node.role, p.node.current_term, p.node.commit_index,
                     p.node.last_applied) for p in self.replicas]
        return [(r.name, r.name in self.stopped, r.view, r._next_exec, sorted(r._exec_queue),
                 len(r._commands), r._vc_sent_for) for r in self.replicas]

    def close(self) -> None:
        for r in self.replicas:
            if self.name_of(r) not in self.stopped:
                (r.close if self.kind == "raft" else r.stop)()
        self.net.stop_pumping()


@contextlib.contextmanager
def timed_attr(owner, name: str, acc: list):
    """``owner.name`` timed into ``acc`` while entered."""
    inner = getattr(owner, name)
    setattr(owner, name, timed(inner, acc))
    try:
        yield
    finally:
        setattr(owner, name, inner)


@contextlib.contextmanager
def timed_batch_serialize(module, acc: list):
    """``module.serialize`` of a window's ``("batch", [...])`` command
    timed into ``acc`` while entered."""
    inner = module.serialize

    def serialize(obj):
        if not (isinstance(obj, tuple) and obj and obj[0] == "batch"):
            return inner(obj)
        t0 = time.perf_counter()
        try:
            return inner(obj)
        finally:
            acc.append(time.perf_counter() - t0)

    module.serialize = serialize
    try:
        yield
    finally:
        module.serialize = inner


def cluster_pass(dev, stream, cluster: Cluster, sync, stages=None, after_window=None,
                 profiler=None, metrics=None, qcs=None, windows=None):
    """One pass of the stream (its ``windows``, all by default; ids cold)
    through a validating
    ``BatchedNotaryService`` on ``dev`` (B8, max_batch 2,048, window_s
    0.005) committing through ``cluster``, by ``process_stream`` at depth 3:
    (the service, its answers, seconds). ``stages`` collects host seconds:
    the replication round (the pending commit's ``collect``), the
    command's serialization, the replicas' apply (Raft) or execute (BFT),
    and for BFT the certificate's build and check. ``after_window(k)`` runs
    once window k has committed; ``qcs`` collects each window's verified
    certificate (or None), in window order."""
    from corda_tpu_torch.notary import BatchedNotaryService, bft, raft
    from corda_tpu_torch.testing import state_resolver

    windows = stream.windows if windows is None else windows
    cold_ids([stx for w in windows for stx in w])
    svc = BatchedNotaryService(stream.notary, stream.notary_keypair, cluster.provider,
                               validating=True, max_batch=NOTARY_WINDOW,
                               window_s=STORM_WINDOW_S, device=dev, metrics=metrics)
    resolve = state_resolver(stream.issue.tx)
    requests = [[(stx, resolve, "alice") for stx in w] for w in windows]
    with contextlib.ExitStack() as stack:
        if stages is not None:
            acc = stages.setdefault
            counted = cluster.provider.commit_batch_async

            def commit_timed(reqs):
                pending = counted(reqs)
                if reqs:  # an empty window's settled pending makes no round
                    pending.collect = timed(pending.collect, acc("replication round", []))
                return pending

            cluster.provider.commit_batch_async = commit_timed
            stack.callback(setattr, cluster.provider, "commit_batch_async", counted)
            stack.enter_context(timed_batch_serialize(
                raft if cluster.kind == "raft" else bft, acc("command serialization", [])))
            for r in cluster.replicas:
                if cluster.kind == "raft":
                    stack.enter_context(timed_attr(r.node, "_apply_fn",
                                                   acc("apply, every replica", [])))
                else:
                    stack.enter_context(timed_attr(r, "_execute",
                                                   acc("execute, every replica", [])))
            if cluster.kind == "bft":
                stack.enter_context(timed_attr(cluster.provider.client, "_try_build_qc",
                                               acc("certificate build", [])))
                stack.enter_context(timed_attr(svc, "_collect_qc",
                                               acc("certificate check", [])))
        if qcs is not None:
            collect_qc = svc._collect_qc

            def recorded_qc():
                qcs.append(collect_qc())
                return qcs[-1]

            svc._collect_qc = recorded_qc
        if after_window is not None:
            settle_sign = svc.settle_sign
            done = [0]

            def settle_then(*args):
                out = settle_sign(*args)
                done[0] += 1
                after_window(done[0])
                return out

            svc.settle_sign = settle_then
        sync()
        t0 = time.perf_counter()
        try:
            if profiler is None:
                out = svc.process_stream(requests, depth=CLUSTER_DEPTH)
            else:
                with profiler:
                    out = svc.process_stream(requests, depth=CLUSTER_DEPTH)
            sync()
            secs = time.perf_counter() - t0
        finally:
            svc.shutdown()
    return svc, out, secs


def check_cluster_answers(out, want, label: str) -> None:
    """Slot for slot, the cluster notary's answers are the single
    notary's: kind, signature bytes, error class and message, conflict."""
    got = [storm_answer(r) for w in out for r in w]
    if got != want:
        bad = [(i, g, w) for i, (g, w) in enumerate(zip(got, want)) if g != w]
        raise AssertionError(f"{label}: {len(bad)} answers differ from the single notary's, "
                             f"first (slot, got, want): {bad[:3]}")


def cluster_phase(dev, card, stream=None, sync=None, profiled=True) -> None:
    """Phase 20: BASELINE config #5 as named, the notary clusters. Phase
    8's stream through a validating ``BatchedNotaryService`` on B8
    committing through (a) a 3-replica Raft cluster and (b) a 4-replica
    BFT cluster with quorum certificates, each held to a single notary's
    answers in the same call; (c) a Raft leader and BFT replicas crashed
    mid-stream; (d) ``tools.loadtest``'s service storm on the Raft-backed
    notary; (e) ``samples.notary_demo.run_demo()`` on the card."""
    import statistics

    import torch

    from corda_tpu_torch.ledger import ComponentGroupType
    from corda_tpu_torch.node import MetricRegistry
    from corda_tpu_torch.notary import InMemoryUniquenessProvider
    from corda_tpu_torch.samples.notary_demo import run_demo
    from corda_tpu_torch.serving import shutdown_scheduler
    from corda_tpu_torch.testing import notary_stream, outcome_kind, state_resolver

    sync = sync or torch.cuda.synchronize
    kernels = phase_kernels()
    must = ("ed25519_challenge", "ed25519_verify_ladder", "sha256_leaves",
            "sha256_merkle_sweep", "ed25519_comb")

    def launches_of(fn, need=must):
        """``fn()``'s launches: every kernel of ``need`` launched, and no
        kernel outside ``must``."""
        for k in kernels:
            k.launches = 0
        out = fn()
        got = {k.__name__: k.launches for k in kernels}
        if min(got[k] for k in need) == 0 or any(v for k, v in got.items() if k not in must):
            raise AssertionError(f"the cluster notary's launches: {got}")
        return got, out

    t0 = time.perf_counter()
    built = stream is None
    if built:
        stream = notary_stream(NOTARY_TXS, NOTARY_WINDOW, seed=20261017, contract_invalid=True,
                               device=dev)
    stxs = [stx for w in stream.windows for stx in w]
    for stx in stxs:
        for g in ComponentGroupType:
            stx.tx.component_bytes(g)
    kinds = [k for w in stream.kinds for k in w]
    n_signed = kinds.count("signed")
    n_windows = len(stream.windows)
    print(f"notary clusters: {len(stxs)} requests in {n_windows} windows of {NOTARY_WINDOW}, "
          + (f"built and signed on the card in {time.perf_counter() - t0:.1f} s"
             if built else "phase 8's stream") + f"; {n_signed} must commit; a validating "
          f"BatchedNotaryService on B8 (window_s {STORM_WINDOW_S}), process_stream depth "
          f"{CLUSTER_DEPTH}; Raft: 3 replicas, submit window {CLUSTER_RETRY_S} s, election "
          f"timeout {CLUSTER_ELECTION_S[0]}-{CLUSTER_ELECTION_S[1]} s, heartbeat "
          f"{CLUSTER_HEARTBEAT_S} s; BFT: 4 "
          f"replicas (f = 1), BLS certificates, quorum wait {CLUSTER_BFT_TIMEOUT_S} s, view "
          f"timeout {CLUSTER_VIEW_TIMEOUT_S} s")
    clusters: list = []
    marks = [("start", time.perf_counter())]

    def mark(label: str) -> None:
        marks.append((label, time.perf_counter()))

    def cluster(kind, tag, **kw):
        c = Cluster(kind, tag, **kw)
        clusters.append(c)
        return c

    def release(c):
        c.close()
        clusters.remove(c)

    try:
        # the single notary's answers to the same stream, in this call
        single_out, single_s = notary_pass(dev, stream, stream.windows, sync=sync,
                                           validating=True)
        check_notary_results(single_out, stream, dev, oracle=False)
        want = [storm_answer(r) for w in single_out for r in w]
        flat = list(zip(stxs, (r for w in single_out for r in w)))

        def implied_digest(n: int) -> str:
            """The consumed set the single notary's first ``n`` answers imply."""
            implied = InMemoryUniquenessProvider()
            implied.commit_batch([(list(stx.tx.inputs), stx.id, "alice")
                                  for stx, r in flat[:n] if outcome_kind(r) == "signed"])
            return implied.consumed_digest()

        single_digest = implied_digest(len(flat))
        fault_windows = stream.windows[:CLUSTER_FAULT_WINDOWS]
        n_fault = sum(len(w) for w in fault_windows)
        want_fault, fault_digest = want[:n_fault], implied_digest(n_fault)
        print(f"notary clusters, beside them: the single notary (PersistentUniquenessProvider) "
              f"{n_signed / single_s:.0f} notarised tx/s  [{card}]")
        mark("the single notary")

        def log_entries(c, term0: int, label: str) -> int:
            """The Raft leader's log after a pass: one entry a window. Only
            when the term rose during the pass may a window stand twice:
            a leader elected mid-pass commits the entries it inherited only
            with one of its own, so the round waiting on them times out and
            submits its window again (idempotent)."""
            log = c.wait_leader(c.live()).node.log.entries
            distinct = len({e.command for e in log})
            if distinct != n_windows or (len(log) != n_windows and c.elections() == term0):
                raise AssertionError(f"raft, {label}: {len(log)} log entries ({distinct} "
                                     f"distinct) for {n_windows} windows, term {term0} -> "
                                     f"{c.elections()}")
            return len(log)

        def pass_note(kind: str, c, term0: int, rounds: list, label: str) -> str:
            """A pass's elections or view changes and its longest round."""
            note = (f"term {term0} -> {c.elections()}, "
                    f"{log_entries(c, term0, label)} log entries for {n_windows} windows"
                    if kind == "raft" else f"view {term0} -> {c.elections()}")
            return note + f", longest round wait {max(rounds):.2f} s"

        for kind, n_steady in zip(("raft", "bft"), CLUSTER_STEADY):
            # the first pass: launches, answers, one round a window, the
            # replicas' consumed sets
            first = cluster(kind, f"{kind}-first")
            term0 = first.elections()
            metrics = MetricRegistry()
            stages: dict = {}
            qcs: list = []
            launches, (svc, out, first_s) = launches_of(
                lambda: cluster_pass(dev, stream, first, sync, stages=stages, metrics=metrics,
                                     qcs=qcs))
            check_cluster_answers(out, want, f"{kind}, first pass")
            if len(first.rounds) != n_windows:
                raise AssertionError(f"{kind}: {len(first.rounds)} rounds, {n_windows} windows")
            round_waits = stages["replication round"]
            first_note = pass_note(kind, first, term0, round_waits, "first pass")
            digests = first.digests()
            if set(digests) != {single_digest}:
                raise AssertionError(f"{kind}: the replicas' consumed sets differ from each "
                                     f"other or from the single notary's: {digests} != "
                                     f"{single_digest}; {first.state()}")
            extra = ""
            if kind == "bft":
                # one certificate a window that the service verified (its
                # notary.qc.cached count; the first one checked again here,
                # a pairing each on the host), cached beside each of its
                # accepted ids that the signed cache still holds (it keeps
                # the newer half past SIGNED_CACHE_MAX)
                if (len(qcs) != n_windows or None in qcs
                        or not qcs[0].verify(first.provider.bls_member_keys)):
                    raise AssertionError(f"bft: window certificates {qcs}")
                if metrics.counter("notary.qc.cached").count != n_windows:
                    raise AssertionError("bft: notary.qc.cached counted "
                                         f"{metrics.counter('notary.qc.cached').count}")
                held = 0
                for q, w, w_kinds in zip(qcs, stream.windows, stream.kinds):
                    for stx, k in zip(w, w_kinds):
                        if k == "signed" and svc.cached_signature(stx.id) is not None:
                            if svc.cached_qc(stx.id) is not q:
                                raise AssertionError(f"bft: {stx.id}'s cached certificate "
                                                     "is not its window's")
                            held += 1
                signers = sorted(q.signer_count() for q in qcs)
                extra = (f"; one verified certificate a window ({signers[0]}-{signers[-1]} "
                         f"of 4 signers), each the cached one of its {held} accepted ids the "
                         f"signed cache holds")
            elections = first.elections()
            release(first)
            print(f"notary cluster ({kind}), first pass: every answer == the single notary's "
                  f"(signature bytes, errors, conflicts), one "
                  f"{'log entry' if kind == 'raft' else 'total-order slot'} a window "
                  f"({n_windows}), every replica's consumed set == the single notary's"
                  f"{extra}; {n_signed / first_s:.0f} notarised tx/s, {first_note}; launches "
                  f"{launches}  [{card}]")
            rates = []
            for i in range(n_steady):
                c = cluster(kind, f"{kind}-steady{i}")
                term0, n_rounds = c.elections(), len(round_waits)
                _svc, out, secs = cluster_pass(dev, stream, c, sync, stages=stages)
                check_cluster_answers(out, want, f"{kind}, steady pass {i + 1}")
                note = pass_note(kind, c, term0, round_waits[n_rounds:], f"steady pass {i + 1}")
                elections = max(elections, c.elections())
                release(c)
                rates.append(n_signed / secs)
                print(f"notary cluster ({kind}), steady pass {i + 1}: every answer == the "
                      f"single notary's; {rates[-1]:.0f} notarised tx/s, {note}  [{card}]")
            rates.sort()
            n_passes = 1 + n_steady
            steady = "no steady pass"
            if rates:
                med = statistics.median(rates)
                steady = (f"steady median {med:.0f} over {n_steady} (min {rates[0]:.0f}, max "
                          f"{rates[-1]:.0f}, spread {(rates[-1] - rates[0]) / med:.1%})")
            print(f"notary cluster ({kind}): first pass {n_signed / first_s:.0f} notarised "
                  f"tx/s, {steady}; the single notary {n_signed / single_s:.0f}; "
                  + (f"highest term {elections}" if kind == "raft" else
                     f"highest view {elections}") + f" over the {n_passes} passes  [{card}]")
            print(f"notary cluster ({kind}), host ms a window over the {n_passes} passes: "
                  + ", ".join(f"{name} {1e3 * sum(v) / (n_passes * n_windows):.2f} "
                              f"({len(v)} calls)" for name, v in stages.items())
                  + f"  [{card}]")
            mark("(a) raft" if kind == "raft" else "(b) bft")

        # (c) faults, once the third window has committed. The notary
        # commits through a follower, as a client would; each of its
        # in-flight forwards to the dead leader times out after the submit
        # window, one after another, and is resubmitted to the new leader.
        # The submit window is 3 s here, not bench.py's 10 (which would
        # stall the stream for half a minute): room for an election at
        # 1-2 s and the resubmit's own retries
        c = cluster("raft", "raft-fault", via_follower=True, retry_s=CLUSTER_FAULT_RETRY_S)
        old = c.leader
        term0 = c.elections()
        _svc, out, secs = cluster_pass(
            dev, stream, c, sync, windows=fault_windows,
            after_window=lambda k: c.stop(old) if k == CLUSTER_FAULT_AFTER else None)
        check_cluster_answers(out, want_fault, "raft, the leader stopped")
        new = c.wait_leader(c.live())
        log = new.node.log.entries  # before digests() adds its no-op
        n_entries = len(log)
        if len({e.command for e in log}) != len(fault_windows):
            raise AssertionError(f"raft failover: {len({e.command for e in log})} distinct log "
                                 f"entries for {len(fault_windows)} windows")
        survivors = c.digests()
        if set(survivors) != {fault_digest}:
            raise AssertionError(f"raft failover: the survivors' consumed sets differ: "
                                 f"{survivors} != {fault_digest}; {c.state()}")
        print(f"notary cluster (raft): the leader {old.node.name} stopped after window "
              f"{CLUSTER_FAULT_AFTER} of {len(fault_windows)}, {new.node.name} elected (term "
              f"{term0} -> {c.elections()}), the windows completed in {secs:.1f} s with every "
              f"answer == the single notary's; the survivors' consumed sets equal; "
              f"{n_entries} log entries for {len(fault_windows)} windows")
        release(c)
        for which in ("a backup", "the primary"):
            c = cluster("bft", f"bft-fault-{which.split()[-1]}")
            stopped = []

            def crash(k, c=c, primary=which == "the primary", stopped=stopped):
                if k == CLUSTER_FAULT_AFTER:
                    stopped.append(next(r for r in reversed(c.replicas)
                                        if r.is_primary == primary))
                    c.stop(stopped[0])

            _svc, out, secs = cluster_pass(dev, stream, c, sync, windows=fault_windows,
                                           after_window=crash)
            victim = stopped[0]
            check_cluster_answers(out, want_fault, f"bft, {which} stopped")
            survivors = c.digests()
            if set(survivors) != {fault_digest}:
                raise AssertionError(f"bft, {which} stopped: the survivors' consumed sets "
                                     f"differ: {survivors} != {fault_digest}; {c.state()}")
            views = [r.view for r in c.live()]
            if which == "the primary" and min(views) < 1:
                raise AssertionError(f"bft: no view change after the primary stopped: {views}")
            print(f"notary cluster (bft): {which} ({victim.name}) stopped after window "
                  f"{CLUSTER_FAULT_AFTER} of {len(fault_windows)}; the windows completed in "
                  f"{secs:.1f} s with every answer == the single notary's, the survivors' "
                  f"consumed sets equal; views {views}")
            release(c)

        mark("(c) faults")

        # (d) tools.loadtest's service storm through request() on the
        # Raft-backed notary (phase 19a's shape)
        by_obj = {id(stx): k for stx, k in zip(stxs, kinds)}
        commits = {i: k == "signed" for i, k in by_obj.items()}
        per_pass = len(stxs) // (STORM_INJECTORS * STORM_CHUNK) * STORM_INJECTORS * STORM_CHUNK
        want_committed = sum(commits[id(stx)] for stx in stxs[:per_pass])
        c = cluster("raft", "raft-storm")
        prof = None
        if profiled:  # the card's busy share over the storm, its activity only
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])
        storm, metrics, storm_s = storm_pass(
            dev, stream, stxs, state_resolver(stream.issue.tx), commits, sync,
            provider=c.provider, committed=ReplicaCount(c.replicas), profiler=prof)
        check_storm(storm, by_obj, dev)
        storm.svc.shutdown()
        if metrics["failed"] or metrics["final_state"] != per_pass:
            raise AssertionError(f"the storm's runner on the raft notary: {metrics}")
        if ReplicaCount(c.replicas).committed_txs() != want_committed:
            raise AssertionError("the storm on the raft notary committed "
                                 f"{ReplicaCount(c.replicas).committed_txs()}, "
                                 f"{want_committed} expected")
        lat = storm.latencies_ms()
        print(f"notary cluster (raft) under tools.loadtest's service storm: {per_pass} requests "
              f"from {STORM_INJECTORS} injectors, the model reconciled ({want_committed} "
              f"committed), every answer its kind, {want_committed / storm_s:.0f} notarised "
              f"tx/s, {len(c.rounds)} rounds, latency p50 {lat[len(lat) // 2]:.1f} ms, p99 "
              f"{lat[int(len(lat) * 0.99)]:.1f} ms; highest term {c.elections()}  [{card}]")
        if prof is not None:
            busy_ms, device_us = device_busy(prof)
            print(f"notary cluster (raft) under the storm, profiled: {storm_s * 1e3:.1f} ms host "
                  f"clock, device busy {busy_ms:.1f} ms = {busy_ms / (storm_s * 1e3):.2%}; by "
                  "name: " + ", ".join(
                      f"{k.split('(')[0]} {v / 1e3:.2f} ms"
                      for k, v in sorted(device_us.items(), key=lambda kv: -kv[1])[:6])
                  + f"  [{card}]")
        release(c)
        mark("(d) the storm")

        # (e) the notary demo (samples/notary-demo) on the card. Its DAG is
        # signed on the card (E) with its ids known, so the batched mode
        # verifies (A, B8) and signs (E) with no id sweep to run
        t0 = time.perf_counter()
        demo_launches, demo = launches_of(lambda: run_demo(device=dev, verbose=False),
                                          need=("ed25519_challenge", "ed25519_verify_ladder",
                                                "ed25519_comb"))
        counts = {(r["notarised"], r["conflicts"]) for r in demo.values()}
        if (list(demo) != ["single", "raft", "bft", "batched-raft"] or len(counts) != 1
                or not all(r["double_spend_rejected"] for r in demo.values())):
            raise AssertionError(f"the notary demo: {demo}")
        print(f"notary demo on the card: every mode notarised {demo['single']['notarised']} "
              f"of its moves and refused the double spend ("
              + ", ".join(f"{m} {r['elapsed_s']} s" for m, r in demo.items())
              + f"; {time.perf_counter() - t0:.1f} s with the DAG's build); launches "
              f"{demo_launches}")
        mark("(e) the demo")
        print("phase 20 by part: " + ", ".join(
            f"{label} {t - t_prev:.1f} s" for (_l, t_prev), (label, t) in zip(marks, marks[1:])))
    finally:
        for c in list(clusters):
            c.close()
        shutdown_scheduler()


TRADER_TRADES = 48     # phase 21: bench.py's TRADER_TRADES
TRADER_WINDOW_S = 0.004  # and its batched notary's window
OOP_WORKERS = 2        # phase 22: worker processes over one broker file
OOP_TXS = 2048         # of phase 17's transactions (the script's time)
OOP_WARMUP = 16        # transactions answered before the timed run
DURABLE_WINDOWS = 8    # phase 23: a prefix of phase 8's stream (the script's time)
DURABLE_CRASH_WINDOW = 3  # the window the WAL's crash strikes in (from 0)
EXIT_PROBE_ROWS = 4096  # the exit probe's rows in flight


def trader_setup(dev, notary_factory, n):
    """A mock network on the card with a seller, a buyer and a notary node
    (``notary_factory``, or the host's validating notary when None); the
    buyer issues itself 1,500 GBP a trade and the seller a paper a trade.
    Returns (net, seller, buyer, notary, papers)."""
    from concurrent.futures import ThreadPoolExecutor

    from corda_tpu_torch.finance import CashIssueFlow
    from corda_tpu_torch.ledger import StateRef
    from corda_tpu_torch.samples.trader_demo import issue_paper
    from corda_tpu_torch.testing.mocknet import MockNetworkNodes

    net = MockNetworkNodes(device=dev)
    try:
        bank = net.create_node("Bank A")
        buyer = net.create_node("Bank B")
        if notary_factory is None:
            notary = net.create_notary_node("Notary", validating=True)
        else:
            notary = net.create_node("Notary", notary_service_factory=notary_factory,
                                     validating_notary=True)
        # bench.py issues one at a time; here 16 at once, to keep the
        # script's time (the setup is untimed)
        with ThreadPoolExecutor(16) as pool:
            list(pool.map(lambda _: buyer.run_flow(
                CashIssueFlow(1500, "GBP", b"\x01", notary.party), timeout=300), range(n)))
            issued = list(pool.map(lambda _: issue_paper(bank, notary.party, face=1000),
                                   range(n)))
        papers = [bank.services.to_state_and_ref(StateRef(stx.id, 0)) for stx in issued]
    except BaseException:
        net.stop()
        raise
    return net, bank, buyer, notary, papers


def trader_trades(bank, buyer, papers, sync) -> float:
    """Every paper offered to the buyer at once (``SellerFlow``) and every
    trade waited for; checks the settlement. Returns host-clock seconds."""
    from corda_tpu_torch.finance import CashState, CommercialPaperState
    from corda_tpu_torch.samples.trader_demo import SellerFlow

    sync()
    t0 = time.perf_counter()
    handles = [bank.smm.start_flow(SellerFlow(buyer.party, sar, 900, "GBP")) for sar in papers]
    swaps = [h.result.result(timeout=300) for h in handles]
    sync()
    secs = time.perf_counter() - t0
    n = len(papers)
    if any(s is None for s in swaps) or len({s.id for s in swaps}) != n:
        raise AssertionError("a trade did not settle")
    deadline = time.monotonic() + 30
    while bank.smm.flows_in_progress() and time.monotonic() < deadline:
        time.sleep(0.05)
    held = len(buyer.services.vault_service.unconsumed_states(CommercialPaperState))
    cash = sum(sr.state.data.amount.quantity
               for sr in bank.services.vault_service.unconsumed_states(CashState))
    if bank.smm.flows_in_progress() or held != n or cash != 900 * n:
        raise AssertionError(f"after {n} trades the buyer holds {held} papers and the seller "
                             f"{cash} GBP (want {n} and {900 * n}); flows left "
                             f"{bank.smm.flows_in_progress()}")
    return secs


def trader_phase(dev, card, n=TRADER_TRADES, sync=None) -> dict:
    """Phase 21: the trader demo (BASELINE config #1, ``bench.py::
    bench_trader_demo``). Returns the launches of the batched notary's
    timed run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from corda_tpu_torch.notary import BatchedNotaryService, PersistentUniquenessProvider
    from corda_tpu_torch.samples.trader_demo import run_demo
    from corda_tpu_torch.serving import shutdown_scheduler

    sync = sync or torch.cuda.synchronize
    kernels = phase_kernels()
    t_phase = time.perf_counter()

    def batched(party, kp):
        return BatchedNotaryService(party, kp, PersistentUniquenessProvider(), validating=True,
                                    max_batch=NOTARY_WINDOW, window_s=TRADER_WINDOW_S,
                                    device=dev)

    t0 = time.perf_counter()
    net, bank, buyer, notary, papers = trader_setup(dev, batched, n)
    try:
        setup_s = time.perf_counter() - t0
        for k in kernels:
            k.launches = 0
        with profile(activities=[ProfilerActivity.CUDA if dev.type == "cuda"
                                 else ProfilerActivity.CPU]) as prof:
            secs = trader_trades(bank, buyer, papers, sync)
        launches = {k.__name__: k.launches for k in kernels}
        busy_ms, device_us = device_busy(prof)
        parks = (bank.smm.parks, buyer.smm.parks, notary.smm.parks)
    finally:
        net.stop()
    must = ("ed25519_challenge", "ed25519_verify_ladder", "sha256_leaves",
            "sha256_merkle_sweep", "ed25519_comb")
    if min(launches[k] for k in must) == 0 or any(
            v for k, v in launches.items() if k not in must):
        raise AssertionError(f"the trader demo's launches: {launches}")
    print(f"trader demo: {n} concurrent trades (offer, swap, notarise, broadcast) against a "
          f"validating BatchedNotaryService node (B8, PersistentUniquenessProvider, max_batch "
          f"{NOTARY_WINDOW}, window_s {TRADER_WINDOW_S}): every trade settled, the buyer holds "
          f"{n} papers, the seller {900 * n} GBP; launches {launches}; parks of seller, buyer, "
          f"notary {parks}; setup {setup_s:.1f} s (untimed)")
    print(f"trader demo: {n / secs:.1f} trades/s ({secs * 1e3:.1f} ms host clock, CUDA activity "
          f"profiled), the card busy {busy_ms:.2f} ms = {busy_ms / (secs * 1e3):.2%}; by name: "
          + ", ".join(f"{k.split('(')[0]} {v / 1e3:.3f} ms"
                      for k, v in sorted(device_us.items(), key=lambda kv: -kv[1])[:6])
          + f"  [{card}]")

    net, bank, buyer, notary, papers = trader_setup(dev, None, n)
    try:
        host_secs = trader_trades(bank, buyer, papers, sync)
    finally:
        net.stop()
    print(f"trader demo, the reference's host shape (create_notary_node(validating=True): "
          f"ValidatingNotaryService, host signatures; the nodes' flows on the card): every "
          f"trade settled, {n / host_secs:.1f} trades/s ({host_secs * 1e3:.1f} ms)  [{card}]")

    summary = run_demo(n_trades=1, verbose=False, device=dev)
    want = {"trades": 1, "buyer_papers": 1, "seller_cash": 900}
    if {k: v for k, v in summary.items() if k != "elapsed_s"} != want:
        raise AssertionError(f"run_demo(n_trades=1) on the card: {summary}")
    shutdown_scheduler()
    print(f"trader demo: run_demo(n_trades=1) on the card == the reference's summary less "
          f"elapsed_s ({summary})")
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s")
    return launches


def oop_worker_env() -> dict:
    """This process's environment, with the repository (this script's
    directory) first on a child process's import path."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    return {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}


def oop_verifier_phase(dev, card, service=None, n=SERVICE_TXS) -> None:
    """Phase 22: the out-of-process verifier. ``service`` is phase 17's
    return (its stream and rate); without it the stream is built here."""
    import os
    import shutil
    import signal
    import tempfile

    from corda_tpu_torch.messaging import DurableQueueBroker
    from corda_tpu_torch.testing.service_stream import service_stream
    from corda_tpu_torch.verifier.worker import (
        VERIFICATION_DEAD_LETTER_QUEUE,
        OutOfProcessVerifierService,
    )

    t_phase = time.perf_counter()
    st = service["stream"] if service else service_stream(n, seed=20261017, device=dev)
    # a worker process has no attachment store: the moves whose contract an
    # attachment of the store carries stay in-process
    keep = [i for i, s in enumerate(st.stxs)
            if all(st.store.get(a) is None for a in s.tx.attachments)][:OOP_TXS]
    want = [st.expected[i] for i in keep]
    tmp = tempfile.mkdtemp(prefix="oop-verifier-")
    path = os.path.join(tmp, "broker.db")
    broker = DurableQueueBroker(path)
    svc = OutOfProcessVerifierService(broker, "chip-node", request_timeout_s=300)
    procs, reports, logs, readers = [], [], [], []
    try:
        for i in range(OOP_WORKERS):
            reports.append(os.path.join(tmp, f"w{i}.json"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "corda_tpu_torch.verifier.worker", path,
                 "--cordapp", "corda_tpu_torch.finance", "--name", f"chip-worker-{i}",
                 "--device", str(dev), "--report", reports[-1]],
                env=oop_worker_env(), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True))
            logs.append([])
            readers.append(threading.Thread(target=lambda f, out: out.extend(f), daemon=True,
                                            args=(procs[-1].stderr, logs[-1])))
            readers[-1].start()
        # every worker serving before the first request: an interrupt must
        # find each one in its loop
        deadline = time.monotonic() + 300
        while not all(any("verifier worker serving" in line for line in log) for log in logs):
            if time.monotonic() > deadline or any(p.poll() is not None for p in procs):
                raise AssertionError(f"a worker did not start: {[''.join(lg)[-1000:] for lg in logs]}")
            time.sleep(0.1)

        def outcome(fut):
            err = fut.exception(timeout=600)
            return None if err is None else str(err).split(":", 1)[0]

        def run(idx):
            futs = [svc.verify_stx(st.stxs[i], st.resolve) for i in idx]
            return [outcome(f) for f in futs]

        t0 = time.perf_counter()
        warm = run(keep[:OOP_WARMUP])
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = run(keep)
        secs = time.perf_counter() - t0
        bad = [(keep[j], st.kinds[keep[j]], g, w) for j, (g, w) in enumerate(zip(got, want))
               if g != (None if w is None else w[0])]
        bad += [(keep[j], "warm-up", g, w) for j, (g, w) in enumerate(zip(warm, want))
                if g != (None if w is None else w[0])]
        if bad:
            raise AssertionError(f"out-of-process verdicts differ from phase 17's: "
                                 f"{len(bad)}, first {bad[:3]}")
        dead = broker.consume(VERIFICATION_DEAD_LETTER_QUEUE, timeout=0.1)
        if svc.pending_count() or svc.timeouts or svc.retries or dead is not None:
            raise AssertionError(f"pending {svc.pending_count()}, timeouts {svc.timeouts}, "
                                 f"retries {svc.retries}, a dead letter {dead}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
        for p, t in zip(procs, readers):
            p.wait(timeout=120)
            t.join(timeout=10)
        svc.shutdown()
        broker.close()
        served = [json.load(open(r)) for r in reports if os.path.exists(r)]
        shutil.rmtree(tmp, ignore_errors=True)
    for p, log in zip(procs, logs):
        err = "".join(log)
        if p.returncode != 0 or "terminate called" in err:
            raise AssertionError(f"a worker exited with rc {p.returncode}: {err[-2000:]}")
    if len(served) != len(procs):
        raise AssertionError(f"{len(procs) - len(served)} worker(s) wrote no report")
    launches = {}
    for rep in served:
        for k, v in rep["launches"].items():
            launches[k] = launches.get(k, 0) + v
    must = ("ed25519_challenge", "ed25519_verify_ladder", "ecdsa_verify_k1", "ecdsa_verify_r1",
            "sphincs_verify")
    if min(launches[k] for k in must) == 0 or any(v for k, v in launches.items()
                                                 if k not in must):
        raise AssertionError(f"the workers' launches: {launches}")
    # two processes can lease one row (the broker's lease is a SELECT, then
    # an UPDATE, under a lock of its own process): a request may be
    # answered twice, and the node keeps the first answer of each nonce
    answered = sum(r["verified"] + r["failed"] for r in served)
    if answered < len(keep) + len(warm) or any(r["malformed"] for r in served):
        raise AssertionError(f"the workers answered {answered} of {len(keep) + len(warm)}: "
                             f"{served}")
    rate17 = f"{service['rate']:.0f}" if service else "not run"
    print(f"out-of-process verifier: {OOP_WORKERS} worker processes (python -m "
          f"corda_tpu_torch.verifier.worker, B8 on the card) over one DurableQueueBroker "
          f"file, fed by OutOfProcessVerifierService: the first {len(keep)} of phase 17's "
          f"{len(st.stxs)} transactions whose contract no attachment carries (those stay "
          f"in-process), every verdict == phase 17's, none unanswered, none "
          f"dead-lettered, each worker rc 0; served {[r['verified'] + r['failed'] for r in served]}"
          f" ({answered - len(keep) - len(warm)} answered twice); the workers' launches "
          f"{launches}")
    print(f"out-of-process verifier: {len(keep) / secs:.0f} verified tx/s ({secs:.2f} s host "
          f"clock; warm-up of {len(warm)} took {warm_s:.1f} s) beside phase 17's in-process "
          f"steady {rate17} tx/s  [{card}]")
    print(f"phase 22: {time.perf_counter() - t_phase:.1f} s")


def durable_notary_phase(dev, card, stream, sync=None) -> dict:
    """Phase 23: the validating notary over ``DurableUniquenessProvider``
    on the card, over the first ``DURABLE_WINDOWS`` windows of ``stream``,
    crashed mid-stream and rebuilt from its directory. Returns the launches
    of its uninterrupted pass."""
    import dataclasses
    import os
    import shutil
    import tempfile

    import torch

    from corda_tpu_torch.crypto import SecureHash, TransactionSignature
    from corda_tpu_torch.durability import DurableStore
    from corda_tpu_torch.faultinject import (
        FaultInjector,
        FaultPlan,
        InjectedCrash,
        clear,
        install,
    )
    from corda_tpu_torch.node.monitoring import node_metrics
    from corda_tpu_torch.notary import (
        BatchedNotaryService,
        DurableUniquenessProvider,
        NotaryError,
        PersistentUniquenessProvider,
    )
    from corda_tpu_torch.serving import shutdown_scheduler
    from corda_tpu_torch.testing import state_resolver

    sync = sync or torch.cuda.synchronize
    kernels = phase_kernels()
    t_phase = time.perf_counter()
    stream = dataclasses.replace(stream, windows=stream.windows[:DURABLE_WINDOWS],
                                 kinds=stream.kinds[:DURABLE_WINDOWS])
    windows = stream.windows
    n = sum(len(w) for w in windows)
    base = tempfile.mkdtemp(prefix="durable-notary-")
    fsync = node_metrics().timer("durability.wal_fsync_s")
    try:
        # the uninterrupted single notary, and its rate
        persistent = PersistentUniquenessProvider()
        oracle, p_secs = notary_pass(dev, stream, windows, sync=sync, validating=True,
                                     provider=persistent)
        want = [answer_of(r) for w in oracle for r in w]
        check_notary_results(oracle, stream, dev, oracle=False)
        print(f"durable notary: the single notary's pass {p_secs:.2f} s", flush=True)
        # the same over the WAL, uninterrupted: its rate and fsyncs
        for k in kernels:
            k.launches = 0
        fs0 = (fsync.snapshot()["count"], fsync.snapshot()["total_s"])
        store = DurableStore(os.path.join(base, "clean"), name="notary")
        snap_s: list = []
        store.snapshot = timed(store.snapshot, snap_s)
        wal = DurableUniquenessProvider(store)
        out, w_secs = notary_pass(dev, stream, windows, sync=sync, validating=True,
                                  provider=wal)
        launches = {k.__name__: k.launches for k in kernels}
        fs1 = (fsync.snapshot()["count"], fsync.snapshot()["total_s"])
        got = [answer_of(r) for w in out for r in w]
        if got != want or wal.consumed_digest() != persistent.consumed_digest():
            raise AssertionError("the durable notary's answers or consumed set differ from "
                                 "the single notary's")
        wal.close()
        must = ("ed25519_challenge", "ed25519_verify_ladder", "sha256_leaves",
                "sha256_merkle_sweep", "ed25519_comb")
        if min(launches[k] for k in must) == 0 or any(
                v for k, v in launches.items() if k not in must):
            raise AssertionError(f"the durable notary's launches: {launches}")
        per_window = (fs1[0] - fs0[0]) / len(windows)
        print(f"durable notary: {n} requests in {len(windows)} windows through a validating "
              f"BatchedNotaryService (B8, process_stream depth {NOTARY_DEPTH}) over "
              f"DurableUniquenessProvider (WAL and snapshots in a temporary directory, the "
              f"reference's defaults: fsync batch {os.environ.get('CORDA_TPU_FSYNC_BATCH', 64)}"
              f" records, snapshot every 4,096): every answer == the single notary's "
              f"(PersistentUniquenessProvider), consumed-set digest equal; launches {launches}")
        print(f"durable notary: {n / w_secs:.0f} notarised tx/s with the WAL beside "
              f"PersistentUniquenessProvider's {n / p_secs:.0f}; {per_window:.1f} fsyncs a "
              f"window, fsync {(fs1[1] - fs0[1]) * 1e3 / len(windows):.2f} ms a window; "
              f"{len(snap_s)} snapshots (the whole map and journal each), "
              f"{sum(snap_s) * 1e3 / len(windows):.2f} ms a window  [{card}]")

        # a crash after an fsync in the middle of window DURABLE_CRASH_WINDOW:
        # windows one at a time, each answered (acknowledged) when it returns
        crash_dir = os.path.join(base, "crash")
        nth = int(DURABLE_CRASH_WINDOW * per_window + per_window // 2)
        for w in windows:
            for stx in w:
                stx.tx.__dict__.pop("_id", None)
        prov = DurableUniquenessProvider(DurableStore(crash_dir, name="notary"))
        svc = BatchedNotaryService(stream.notary, stream.notary_keypair, prov,
                                   validating=True, max_batch=NOTARY_WINDOW, device=dev)
        resolve = state_resolver(stream.issue.tx)
        requests = [[(stx, resolve, "alice") for stx in w] for w in windows]
        acked = []
        install(FaultInjector(FaultPlan(seed=2026,
                                        crash_sites=(("durability.wal.post_fsync", nth),))))
        try:
            for w in requests:
                acked.append(svc.process_batch(w))
            raise AssertionError(f"the crash at fsync {nth} never fired")
        except InjectedCrash:
            pass
        finally:
            clear()
        k = len(acked)
        if not 1 <= k < len(windows):
            raise AssertionError(f"the crash struck in window {k}, not mid-stream")
        del svc, prov  # the crash: every in-memory object is gone
        t0 = time.perf_counter()
        prov = DurableUniquenessProvider(DurableStore(crash_dir, name="notary"))
        svc = BatchedNotaryService(stream.notary, stream.notary_keypair, prov,
                                   validating=True, max_batch=NOTARY_WINDOW, device=dev)
        rebuild_s = time.perf_counter() - t0
        rec = prov.last_recovery
        # every acknowledged attestation came back from the journal
        journal = prov.recovered_signatures()
        acked_sigs = [(stx.id, r) for w_in, w_out in zip(windows, acked)
                      for stx, r in zip(w_in, w_out) if isinstance(r, TransactionSignature)]
        lost = [t for t, r in acked_sigs if t not in journal
                or journal[t].signature != r.signature]
        if lost:
            raise AssertionError(f"{len(lost)} acknowledged attestations not recovered")
        # the unanswered windows resubmitted to the rebuilt notary
        for w in windows[k:]:
            for stx in w:
                stx.tx.__dict__.pop("_id", None)
        rest = svc.process_stream(requests[k:], depth=NOTARY_DEPTH)
        got = [answer_of(r) for w in acked + rest for r in w]
        if got != want:
            bad = [(i, g, w_) for i, (g, w_) in enumerate(zip(got, want)) if g != w_]
            raise AssertionError(f"after the crash {len(bad)} answers differ from the single "
                                 f"notary's, first {bad[:3]}")
        if prov.consumed_digest() != persistent.consumed_digest():
            raise AssertionError("the recovered consumed set differs from the single notary's")
        # a retried acknowledged request: its original signature bytes
        retry = [(stx, resolve, "alice") for stx in windows[0][:64]]
        for stx, _r, _c in retry:
            stx.tx.__dict__.pop("_id", None)
        again = [svc.request(*t) for t in retry]
        for fut, first in zip(again, acked[0][:64]):
            err = fut.exception(timeout=120)
            if answer_of(fut.result() if err is None else err) != answer_of(first):
                raise AssertionError("a retried acknowledged request got another answer")
        svc.shutdown()
        # no double spend: a new transaction over a consumed input conflicts
        spent = next(stx for stx, r in zip(windows[1], oracle[1])
                     if isinstance(r, TransactionSignature))
        try:
            prov.commit(list(spent.inputs), SecureHash(hashlib.sha256(b"mallory").digest()),
                        "mallory")
        except NotaryError:
            pass
        else:
            raise AssertionError("the recovered notary admitted a double spend")
        prov.close()
        print(f"durable notary: crash at fsync {nth} (durability.wal.post_fsync) in window {k} "
              f"after {k} windows acknowledged; rebuilt from the directory alone in "
              f"{rebuild_s:.3f} s (replayed {rec.replayed} records over the snapshot at LSN "
              f"{rec.snapshot_lsn}, {rec.torn} torn, recovery {rec.wall_s:.3f} s); every "
              f"acknowledged attestation recovered ({len(acked_sigs)}), the {len(windows) - k} "
              f"unanswered windows resubmitted: every answer == the single notary's, "
              f"consumed-set digest equal, a retried acknowledged request answered with its "
              f"original signature bytes, a double spend refused  [{card}]")
    finally:
        shutil.rmtree(base, ignore_errors=True)
        shutdown_scheduler()
    print(f"phase 23: {time.perf_counter() - t_phase:.1f} s")
    return launches


STATESTORE_SLOTS = 2 ** 14     # phase 24a: two tables held against their plain versions,
STATESTORE_PROBES = (32, 8)    # at these probe windows (the second crowded until it overflows
STATESTORE_HOMES = 1024       # onto this many home slots)
STATESTORE_REQUESTS = 1024     # 24a: commit batches of 1,024 requests of 2 refs,
STATESTORE_BATCHES = 4         # 8,192 commit rows in all
STATESTORE_REMOVES = 2048
STATESTORE_NOTARY_SLOTS = 2 ** 20  # 24b's and 24d's tables
SCALE_SLOTS = 2 ** 23          # 24c: 8,388,608 slots x 68 bytes = 570 MB on the card
SCALE_PRELOAD = 4_000_000      # rows preloaded (47.7% of the slots)
SCALE_PRELOAD_BATCH = 65536
SCALE_BATCHES = 64             # stream_commit_requests batches of
SCALE_BATCH = 4096             # 4,096 requests,
SCALE_DOUBLE_SPEND = 0.002     # their double_spend_fraction
SCALE_ROWS = 8192              # rows probed present and absent; I's and K's timed rows
STATESTORE_DURABLE_WINDOWS = 4  # 24d: a prefix of phase 8's stream
VAULT_INDEX_SLOTS = 4096       # 24e: each node's index (the gate's default)


def statestore_kernels() -> tuple:
    """Kernels I, J and K's wrappers."""
    from corda_tpu_torch.ops.statestore import (
        statestore_commit,
        statestore_probe,
        statestore_remove,
    )

    return statestore_probe, statestore_commit, statestore_remove


def ss_rows(rng, n, homes=None):
    """(n, 8) int32 key rows over the whole int32 range; with ``homes``,
    word 2 (the home slot) takes one of that many values."""
    import numpy as np

    out = rng.integers(-2**31, 2**31, size=(n, 8), dtype=np.int64).astype(np.int32)
    if homes is not None:
        out[:, 2] = rng.integers(-2**31, 2**31, size=homes, dtype=np.int64).astype(
            np.int32)[rng.integers(0, homes, size=n)]
    return out


def ss_sequence(seed: int, crowded: bool) -> list:
    """Phase 24a's op sequence on host arrays: STATESTORE_BATCHES commit
    batches of STATESTORE_REQUESTS requests of 2 refs (10% of the requests
    conflict with a committed key under another tx, 5% retry a committed
    request identically; a few rows not valid, a few host conflicts and
    forced requests), STATESTORE_REMOVES removes (a key twice, absent keys),
    a batch re-inserting removed keys over their tombstones, and probes.
    Crowded: the home slots take STATESTORE_HOMES values, so windows
    overflow."""
    import numpy as np

    rng = np.random.default_rng(seed)
    r, k = STATESTORE_REQUESTS, 2
    pool = ss_rows(rng, r * k * (STATESTORE_BATCHES + 1), STATESTORE_HOMES if crowded else None)
    nxt = 0
    committed = []          # (pool index pair, tx row) of every request
    seq = []

    def commit(reqs):
        q = pool[[i for pair, _tx in reqs for i in pair]].reshape(len(reqs), k, 8)
        qtx = np.stack([tx for _pair, tx in reqs])
        valid = (rng.random((len(reqs), k)) >= 0.02).astype(np.int32)
        pre = (rng.random(len(reqs)) < 0.01).astype(np.int32)
        force = (rng.random(len(reqs)) < 0.02).astype(np.int32)
        seq.append(("commit", q, qtx, q[:, :, 0].copy(), valid, pre, force))

    for _b in range(STATESTORE_BATCHES):
        reqs, used = [], set()
        for _ in range(r):
            roll = rng.random()
            if committed and roll < 0.15:
                pair, tx = committed[rng.integers(len(committed))]
                if used.isdisjoint(pair):
                    if roll < 0.10:        # a conflict: the keys under another tx
                        tx = ss_rows(rng, 1)[0]
                    reqs.append((pair, tx))
                    used.update(pair)
                    continue
            pair = (nxt, nxt + 1)
            nxt += 2
            reqs.append((pair, ss_rows(rng, 1)[0]))
            used.update(pair)
        commit(reqs)
        committed.extend(reqs)
    keys = [i for pair, _tx in committed for i in pair]
    picks = rng.choice(np.array(keys), size=STATESTORE_REMOVES)
    rm = pool[picks]
    rm[1::97] = rm[0::97][:len(rm[1::97])]                 # keys twice
    rm[5::101] = ss_rows(rng, len(rm[5::101]))             # absent keys
    seq.append(("remove", rm))
    gone = list(dict.fromkeys(picks.tolist()))[: 2 * r]
    reqs = [((gone[2 * j], gone[2 * j + 1]), ss_rows(rng, 1)[0]) for j in range(len(gone) // 2)]
    commit(reqs)                                           # over the tombstones
    seq.append(("probe", np.concatenate([pool[: r * k * STATESTORE_BATCHES: 3], rm[:1000]])))
    return seq


def hold_statestore_kernels(dev, card) -> int:
    """Phase 24a: kernels I, J and K against their plain versions on the
    card, one seeded op sequence on two tables each (one through the
    kernels, one through the plain versions) at each geometry. Returns the
    largest difference (0: every output and table word equal)."""
    import torch

    from corda_tpu_torch.ops import statestore as ops

    t0 = time.perf_counter()
    err = 0
    for geometry, max_probe in enumerate(STATESTORE_PROBES):
        crowded = geometry == 1
        seq = ss_sequence(24 + geometry, crowded)
        tables = [[torch.zeros((STATESTORE_SLOTS, 8), dtype=torch.int32, device=dev),
                   torch.zeros((STATESTORE_SLOTS, 8), dtype=torch.int32, device=dev),
                   torch.zeros(STATESTORE_SLOTS, dtype=torch.int32, device=dev)]
                  for _ in range(2)]
        counts = {"overflow": 0, "conflict": 0, "inserted": 0, "removed": 0, "found": 0}
        for step, op in enumerate(seq):
            args = [torch.from_numpy(a).to(dev) for a in op[1:]]
            outs = []
            for t, fn in zip(tables, ("kernel", "plain")):
                if op[0] == "commit":
                    f = ops.statestore_commit if fn == "kernel" else ops.statestore_commit_plain
                    outs.append(f(*t, *args, max_probe))
                elif op[0] == "remove":
                    valid = torch.ones(args[0].shape[0], dtype=torch.int32, device=dev)
                    f = ops.statestore_remove if fn == "kernel" else ops.statestore_remove_plain
                    outs.append(f(*t, args[0], valid, max_probe))
                else:
                    f = ops.statestore_probe if fn == "kernel" else ops.statestore_probe_plain
                    outs.append(f(t[0], t[2], args[0], max_probe))
            torch.cuda.synchronize()
            got, want = outs
            err = max(err, int((got.long() - want.long()).abs().max()))
            if not torch.equal(got, want):
                bad = torch.nonzero(got != want).flatten().tolist()
                raise AssertionError(f"kernel {'IJK'[('probe', 'commit', 'remove').index(op[0])]}"
                                     f" != plain at step {step} ({op[0]}), max_probe "
                                     f"{max_probe}: outputs differ at {bad[:10]}")
            for a, b in zip(*tables):
                if not torch.equal(a, b):
                    raise AssertionError(f"the tables differ after step {step} ({op[0]}), "
                                         f"max_probe {max_probe}")
            w = want.cpu().numpy()
            if op[0] == "commit":
                r, k = op[1].shape[:2]
                counts["conflict"] += int(w[:r].sum())
                counts["overflow"] += int(w[r:r + r * k].sum())
                counts["inserted"] += int(w[-1])
            elif op[0] == "remove":
                counts["removed"] += int(w[-1])
                tombs = int((tables[0][2] == ops.TOMBSTONE).sum())
            else:
                counts["found"] += int(w.sum())
        live = int(((tables[0][2] & 1) != 0).sum())
        reused = tombs - int((tables[0][2] == ops.TOMBSTONE).sum())
        if crowded and not counts["overflow"]:
            raise AssertionError("the crowded table never overflowed a window")
        if not (counts["conflict"] and counts["removed"] and tombs and reused):
            raise AssertionError(f"the sequence missed a branch: {counts}")
        print(f"statestore kernels I, J, K == plain on the card: {STATESTORE_SLOTS} slots, "
              f"max_probe {max_probe}"
              f"{f' (crowded: {STATESTORE_HOMES} home slots)' if crowded else ''}: "
              f"{STATESTORE_BATCHES} commit batches of {STATESTORE_REQUESTS} requests x 2 refs "
              f"(10% conflicting, 5% identical retries), {STATESTORE_REMOVES} removes, a "
              f"re-insert batch over the tombstones, probes; every verdict, overflow, removed "
              f"and found bit and every keys/txs/tags word equal (max_abs_err {err}); {counts}, "
              f"{live} live, {tombs} tombstones after the removes, {reused} of them "
              f"re-inserted over")
    print(f"phase 24a: {time.perf_counter() - t0:.1f} s")
    return err


def ss_window_live(tags, q, max_probe: int) -> int:
    """Live slots over the windows of the rows ``q``: the keys a probe of
    them must read."""
    from corda_tpu_torch.ops import statestore as ops

    win = ops.windows(q, tags.shape[0], max_probe)
    return int(((tags[win] & 1) != 0).sum())


def ss_probe_bytes(tags, q, max_probe: int) -> int:
    """Bytes kernel I must move for the rows ``q`` on this table: each row
    and its window's tags read once, the key of each live window slot read
    once (it is compared), one output word written."""
    return q.shape[0] * (32 + 4 * max_probe + 4) + 32 * ss_window_live(tags, q, max_probe)


def ss_commit_bytes(tags, keys, args, out, max_probe: int) -> int:
    """Bytes kernel J must move for one commit on the table before it:
    its inputs read once (the rows, txs, tags, flags), the window tags and
    the keys of their live slots, the stored tx of each present key, each
    inserted slot written (68 bytes), its output written."""
    from corda_tpu_torch.ops import statestore as ops

    q, qtx, _qtag, valid = args[:4]
    r, k = q.shape[:2]
    qf = q.reshape(r * k, 8)[valid.reshape(-1) != 0]
    hits = int(ops.statestore_probe_plain(keys, tags, qf, max_probe).sum())
    return (r * k * (32 + 4 + 4) + r * (32 + 4 + 4) + qf.shape[0] * 4 * max_probe
            + 32 * ss_window_live(tags, qf, max_probe) + 32 * hits + 68 * int(out[-1])
            + 4 * (r + r * k + 1))


def chase_ns(dev, slots: int, hops: int = 200_000) -> float:
    """Nanoseconds of one dependent load from device memory: a one-thread
    chase (``ct_statestore_chase``) through a random cycle over an array as
    large as the table's tags."""
    import torch

    from corda_tpu_torch.ops import _build

    perm = torch.randperm(slots, device=dev, dtype=torch.int64)
    nxt = torch.empty(slots, dtype=torch.int32, device=dev)
    nxt[perm] = torch.roll(perm, -1).to(torch.int32)
    out = torch.empty(1, dtype=torch.int32, device=dev)
    lib = _build.kernels()
    ms = cuda_ms(lambda: _build.check_launch(lib.ct_statestore_chase(
        nxt.data_ptr(), hops, out.data_ptr(), _build.stream_of(nxt)), "statestore_chase"), 3)
    return ms * 1e6 / hops


def ss_restore(table, saved) -> None:
    """Copy ``saved`` back into the table's tensors (a function, so that no
    loop variable outlives it holding a table tensor)."""
    for dst, src in zip(table, saved):
        dst.copy_(src)


def ss_reset(table, saved, q, max_probe: int, flush):
    """A function that puts back from ``saved`` the slots of the windows of
    the rows ``q`` (every slot kernels J and K can write for them), then
    writes ``flush`` (larger than the card's L2 cache): the next run finds
    the table as before the first, and its windows cold, as a batch of the
    provider finds them."""
    import torch

    from corda_tpu_torch.ops import statestore as ops

    idx = torch.unique(ops.windows(q.reshape(-1, 8), table[2].shape[0], max_probe).flatten())

    def reset():
        for dst, src in zip(table, saved):
            dst[idx] = src[idx]
        flush.zero_()

    return reset


def reset_ms(run, reset, reps: int) -> float:
    """Device ms of ``run`` on a table ``reset`` before each run, the stream
    held (``device_times``): the time of reset and run, less reset's alone."""
    both = device_times(lambda: (reset(), run()), reps)[0]
    return both - device_times(reset, reps)[0]


def ss_rounds(counts) -> tuple[list, int]:
    """(rows freed in each round, rows walked) from a launch's counts."""
    from corda_tpu_torch.ops import statestore as ops

    c = counts.cpu().tolist()
    return [n for n in c[:ops.MAX_ROUNDS] if n], c[ops.COUNTS - 1]


def scale_load(dev, card, sync):
    """Phase 24c's table: a scale-mode provider over SCALE_SLOTS slots,
    preloaded with SCALE_PRELOAD rows through ``insert_rows`` (its rate
    printed), then SCALE_BATCHES batches of the streamed commit requests
    (every flagged double spend conflicts, nothing else), and the probes.
    Returns (the provider, preloaded rows that probe present, the request
    stream, the row generator)."""
    import itertools

    import numpy as np
    import torch

    from corda_tpu_torch.statestore import DeviceShardedUniquenessProvider
    from corda_tpu_torch.testing import stream_commit_requests

    prov = DeviceShardedUniquenessProvider(device=dev, slots_per_shard=SCALE_SLOTS, shadow=False)
    table = prov._table
    print(f"statestore scale: a scale-mode provider (shadow=False) over {SCALE_SLOTS} slots x "
          f"68 bytes = {SCALE_SLOTS * 68 / 1e6:.0f} MB of device memory, max_probe "
          f"{table.max_probe}; allocated {torch.cuda.memory_allocated(dev) / 1e6:.0f} MB")
    rng = np.random.default_rng(2026)
    present, overflowed = [], 0
    sync()
    t1 = time.perf_counter()
    for lo in range(0, SCALE_PRELOAD, SCALE_PRELOAD_BATCH):
        m = min(SCALE_PRELOAD_BATCH, SCALE_PRELOAD - lo)
        rows = ss_rows(rng, m)
        ov = table.insert_rows(rows, ss_rows(rng, m))
        overflowed += int(ov.sum())
        present.append(rows[~ov][: SCALE_ROWS // 61 + 1])
    sync()
    preload_s = time.perf_counter() - t1
    present = np.concatenate(present)[:SCALE_ROWS]
    if table.n_live != SCALE_PRELOAD - overflowed:
        raise AssertionError(f"{table.n_live} live rows after preloading {SCALE_PRELOAD}")
    print(f"statestore scale: preloaded {SCALE_PRELOAD} seeded rows through insert_rows in "
          f"batches of {SCALE_PRELOAD_BATCH} in {preload_s:.2f} s = "
          f"{SCALE_PRELOAD / preload_s:.0f} rows/s, load {table.occupancy():.1%}, "
          f"{overflowed} overflowed  [{card}]")

    gen = stream_commit_requests(seed=2026, n_states=10**9,
                                 double_spend_fraction=SCALE_DOUBLE_SPEND)
    flagged = conflicts = n_req = 0
    commit_s = []
    for _ in range(SCALE_BATCHES):
        batch = list(itertools.islice(gen, SCALE_BATCH))
        t1 = time.perf_counter()
        got = prov.commit_batch([(list(r.refs), r.tx_id, r.caller) for r in batch])
        commit_s.append(time.perf_counter() - t1)
        for r, v in zip(batch, got):
            if (v is not None) != r.expect_conflict:
                raise AssertionError(f"request {r.tx_id}: conflict {v is not None}, flagged "
                                     f"{r.expect_conflict}")
        flagged += sum(r.expect_conflict for r in batch)
        conflicts += sum(v is not None for v in got)
        n_req += len(batch)
    if not flagged:
        raise AssertionError("the stream flagged no double spend")
    print(f"statestore scale: {SCALE_BATCHES} batches of {SCALE_BATCH} stream_commit_requests "
          f"(seed 2026, double_spend_fraction {SCALE_DOUBLE_SPEND}): every one of the {flagged} "
          f"flagged double "
          f"spends conflicts and nothing else ({conflicts} conflicts); {n_req / sum(commit_s):.0f}"
          f" requests/s through commit_batch, {np.median(commit_s) * 1e3:.2f} ms a batch "
          f"(median, host clock); {prov.spill_count()} spilled, load {table.occupancy():.1%}  "
          f"[{card}]")
    fresh = ss_rows(rng, SCALE_ROWS)
    if not table.probe_rows(present).all() or table.probe_rows(fresh).any():
        raise AssertionError("a preloaded row probed absent or a fresh one present")
    print(f"statestore scale: {len(present)} preloaded rows probe present, {SCALE_ROWS} fresh "
          f"rows absent")
    return prov, present, gen, rng


def scale_kernel_times(dev, card, int_rate, sync, table, present, gen, rng,
                       hold: bool = True) -> dict:
    """Kernels I, J and K timed on phase 24c's loaded table: I at the
    SCALE_ROWS preloaded rows, J at the stream's next SCALE_BATCH requests
    and at one batch of SCALE_PRELOAD_BATCH fresh rows (as ``insert_rows``
    sends them), K at the SCALE_ROWS rows; J and K on the table reset before
    each run (``ss_reset``). With ``hold``, each is held against its plain
    version (J's preload-sized batch, whose plain run would take seconds,
    against the same launch forced to walk every row: tables, outputs and
    bucket marks), and J's and K's rounds, walked rows and serial floors are
    printed. Returns {name: (ms, plain ms or None, bound, max_abs_err)},
    J's preload-sized batch under "statestore_commit@preload"."""
    import itertools

    import numpy as np
    import torch

    from corda_tpu_torch.notary.uniqueness import _ref_key
    from corda_tpu_torch.ops import statestore as ops
    from corda_tpu_torch.statestore import key_rows
    from corda_tpu_torch.ops.opcount import statestore_int_ops

    W = table.max_probe
    counted = {f: f.launches for f in statestore_kernels()}
    saved = [t.clone() for t in (table._keys, table._txs, table._tags)]
    tab = [table._keys, table._txs, table._tags]
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.int32, device=dev)
    results, rounds, walk_ms = {}, {}, None
    q_i = torch.from_numpy(present).to(dev)
    got = ops.statestore_probe(table._keys, table._tags, q_i, W)
    want = ops.statestore_probe_plain(table._keys, table._tags, q_i, W)
    err_i = int((got.long() - want.long()).abs().max())
    if err_i or not bool(got.all()):
        raise AssertionError("kernel I != plain at scale")
    ms_i = cuda_ms(lambda: ops.statestore_probe(table._keys, table._tags, q_i, W), 50)
    p_i = plain_ms(lambda: ops.statestore_probe_plain(table._keys, table._tags, q_i, W), 3) \
        if hold else None
    b_i = bound(ss_probe_bytes(table._tags, q_i, W), statestore_int_ops(q_i.shape[0], W), int_rate)
    results["statestore_probe"] = (ms_i, p_i, b_i, err_i)

    batch = list(itertools.islice(gen, SCALE_BATCH))
    k = max(1, max(len(r.refs) for r in batch))
    q = np.zeros((SCALE_BATCH, k, 8), np.int32)
    valid = np.zeros((SCALE_BATCH, k), np.int32)
    for i, r in enumerate(batch):
        if r.refs:
            q[i, :len(r.refs)] = key_rows([_ref_key(ref) for ref in r.refs])
            valid[i, :len(r.refs)] = 1
    qtx = np.stack([np.frombuffer(r.tx_id.bytes, dtype="<i4") for r in batch])
    zeros = np.zeros(SCALE_BATCH, np.int32)
    args = table._upload(q, qtx, q[:, :, 0], valid, zeros, zeros)
    m = SCALE_PRELOAD_BATCH
    rows = ss_rows(rng, m)
    ones = np.ones(m, np.int32)
    args_p = table._upload(rows.reshape(m, 1, 8), ss_rows(rng, m), rows[:, :1].copy(),
                           ones.reshape(m, 1), np.zeros(m, np.int32), ones)
    q_k = q_i
    valid_k = torch.ones(q_k.shape[0], dtype=torch.int32, device=dev)
    jobs = (("statestore_commit", args, lambda: ops.statestore_commit(*tab, *args, W)),
            ("statestore_commit@preload", args_p,
             lambda: ops.statestore_commit(*tab, *args_p, W)),
            ("statestore_remove", (q_k, valid_k),
             lambda: ops.statestore_remove(*tab, q_k, valid_k, W)))
    for name, a, run in jobs:
        reset = ss_reset(tab, saved, a[0], W, flush)
        reset()
        out = run()
        after_kernel = [t.clone() for t in tab] if hold else None
        ms = reset_ms(run, reset, 5 if name == "statestore_commit@preload" else 20)
        reset()
        err, p_ms = 0, None
        if name == "statestore_remove":
            b = bound(q_k.shape[0] * (32 + 4 + 4 * W + 4) + 32 * ss_window_live(saved[2], q_k, W)
                      + 68 * int(out[-1]) + 4, statestore_int_ops(q_k.shape[0], W), int_rate)
        else:
            b = bound(ss_commit_bytes(saved[2], saved[0], a, out.cpu().numpy(), W),
                      statestore_int_ops(int(a[3].sum()), W), int_rate)
        if hold:
            if name == "statestore_commit@preload":
                # the same launch forced to walk every row: the serial order itself
                want, counts_w, marks_w = ops._commit_launch(*tab, *a, W, 2**31 - 1)
                if ss_rounds(counts_w)[0] or not bool((marks_w == ops.UNMARKED).all()):
                    raise AssertionError("the forced walk ran a round or left a mark")
            else:
                sync()
                t1 = time.perf_counter()
                if name == "statestore_commit":
                    want = ops.statestore_commit_plain(*tab, *a, W)
                else:
                    want = ops.statestore_remove_plain(*tab, *a, W)
                sync()
                p_ms = (time.perf_counter() - t1) * 1e3
            err = int((out.long() - want.long()).abs().max())
            if err or not all(torch.equal(x, y) for x, y in zip(after_kernel, tab)):
                raise AssertionError(f"{name} != {'the forced walk' if p_ms is None else 'plain'}"
                                     " at scale")
            del after_kernel
            if name == "statestore_commit@preload":
                walk_ms = reset_ms(lambda: ops._commit_launch(*tab, *a, W, 2**31 - 1), reset, 3)
            reset()
            launch = ops._remove_launch if name == "statestore_remove" else ops._commit_launch
            _, counts, marks = launch(*tab, *a, W, ops.ROUND_MIN_FREE)
            if not bool((marks == ops.UNMARKED).all()):
                raise AssertionError(f"{name} left a bucket mark set")
            rounds[name] = ss_rounds(counts)
            reset()
        results[name] = (ms, p_ms, b, err)
    ss_restore(tab, saved)
    del saved, flush
    for f, n_launch in counted.items():
        f.launches = n_launch
    lat = chase_ns(dev, SCALE_SLOTS)
    print(f"statestore scale: one dependent load from device memory (a chase over "
          f"{SCALE_SLOTS * 4 / 1e6:.0f} MB) {lat:.1f} ns  [{card}]")
    shapes = {"statestore_probe": f"{q_i.shape[0]} rows",
              "statestore_commit": f"{SCALE_BATCH} requests ({int(valid.sum())} valid rows)",
              "statestore_commit@preload": f"{m} fresh rows (a preload batch)",
              "statestore_remove": f"{q_k.shape[0]} rows"}
    for name, (ms, p_ms, (b_ms, b_by), e) in results.items():
        line = (f"{name}: {ms:.4f} ms on the card at {shapes[name]}, load "
                f"{SCALE_PRELOAD / SCALE_SLOTS:.1%}"
                f"{'' if name == 'statestore_probe' else ', windows reset and cold'}"
                f"{f' (plain {p_ms:.1f} ms)' if p_ms is not None else ''}; bound {b_ms:.4f} ms "
                f"by {b_by}, {b_ms / ms:.1%} of it")
        if name == "statestore_commit@preload" and hold:
            line += f"; the same launch forced to walk every row {walk_ms:.4f} ms"
        if name in rounds:
            freed, walked = rounds[name]
            floor = (len(freed) + walked) * lat / 1e6
            line += (f"; rows freed a round {freed}, {walked} walked; serial floor {floor:.4f} "
                     f"ms ({len(freed)} rounds + {walked} walked rows, one dependent load "
                     f"each), {floor / ms:.1%} of it")
        print(line + f"; max_abs_err {e}  [{card}]")
    return results


def statestore_scale(dev, card, int_rate, sync) -> dict:
    """Phase 24c: the loaded table (``scale_load``), kernels I, J and K timed
    and held there (``scale_kernel_times``), then the provider closed and
    its table freed. Returns ``scale_kernel_times``' results."""
    import gc

    import torch

    from corda_tpu_torch.statestore import statestore_section

    t0 = time.perf_counter()
    prov, present, gen, rng = scale_load(dev, card, sync)
    table = prov._table
    results = scale_kernel_times(dev, card, int_rate, sync, table, present, gen, rng)
    prov.close()
    if any(t["slots_per_shard"] == SCALE_SLOTS
           for t in statestore_section().get("tables", [])):
        raise AssertionError("the closed scale provider's table is still in the section")
    held = torch.cuda.memory_allocated(dev)
    del prov, table
    gc.collect()
    torch.cuda.empty_cache()
    freed = held - torch.cuda.memory_allocated(dev)
    if freed < SCALE_SLOTS * 68:
        raise AssertionError(f"dropping the scale provider freed {freed} bytes of the card, "
                             f"less than its table's {SCALE_SLOTS * 68}")
    print(f"statestore scale: dropping the provider freed {freed / 1e6:.0f} MB of the card")
    print(f"phase 24c: {time.perf_counter() - t0:.1f} s")
    return results


def statestore_notary(dev, card, stream, sync) -> None:
    """Phase 24b: phase 8's stream through a validating BatchedNotaryService
    over DeviceShardedUniquenessProvider on the card, against the same
    notary over InMemoryUniquenessProvider."""
    from torch.profiler import ProfilerActivity, profile

    from corda_tpu_torch.notary import InMemoryUniquenessProvider
    from corda_tpu_torch.statestore import DeviceShardedUniquenessProvider

    t0 = time.perf_counter()
    windows = stream.windows
    n = sum(len(w) for w in windows)
    passes = {}
    for label in ("in-memory first", "device first", "in-memory steady", "device steady"):
        host = {"ids": [], "commit": [], "sign": []}
        if label.startswith("device"):
            prov = DeviceShardedUniquenessProvider(device=dev,
                                                   slots_per_shard=STATESTORE_NOTARY_SLOTS)
        else:
            prov = InMemoryUniquenessProvider()
        if label == "device steady":
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out, secs = notary_pass(dev, stream, windows, sync=sync, validating=True,
                                        provider=prov, host_times=host)
            busy_ms, device_us = device_busy(prof)
            j_us = sum(v for key, v in device_us.items() if "statestore" in key)
        else:
            out, secs = notary_pass(dev, stream, windows, sync=sync, validating=True,
                                    provider=prov, host_times=host)
        passes[label] = (prov, [answer_of(r) for w in out for r in w], secs, host)
        if label == "in-memory first":
            check_notary_results(out, stream, dev, oracle=False)
    mem, want = passes["in-memory first"][:2]
    for label, (prov, got, _secs, _host) in passes.items():
        if got != want:
            bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
            raise AssertionError(f"{label}: {len(bad)} answers differ from the in-memory "
                                 f"notary's, first slots {bad[:5]}")
        if label.startswith("device"):
            if prov.consumed_digest() != mem.consumed_digest() or prov.device_divergence():
                raise AssertionError(f"{label}: the consumed set differs from the in-memory "
                                     "provider's")
    dev_prov = passes["device first"][0]
    stats = dev_prov.table_stats()
    host_ms = passes["device steady"][3]["commit"]
    print(f"statestore notary: {n} requests in {len(windows)} windows (phase 8's stream) through "
          f"a validating BatchedNotaryService (B8, process_stream depth {NOTARY_DEPTH}) over "
          f"DeviceShardedUniquenessProvider on the card ({STATESTORE_NOTARY_SLOTS} slots, "
          f"max_probe {stats['max_probe']}): every answer == the in-memory provider's, slot for "
          f"slot; consumed_digest equal, device_divergence 0, {dev_prov.spill_count()} spilled, "
          f"{stats['live_rows']} live rows")
    print("statestore notary: notarised tx/s " + ", ".join(
        f"{label} {n / secs:.0f}" for label, (_p, _g, secs, _h) in passes.items())
        + f"; the device provider's commit {sum(host_ms) * 1e3 / len(windows):.2f} host ms a "
        f"window (commit_batch_async; in-memory "
        f"{sum(passes['in-memory steady'][3]['commit']) * 1e3 / len(windows):.2f}), kernel J "
        f"{j_us / 1e3 / len(windows):.3f} device ms a window; the card busy "
        f"{busy_ms / (passes['device steady'][2] * 1e3):.1%} of the steady pass  [{card}]")
    for prov, *_rest in passes.values():
        if hasattr(prov, "close"):
            prov.close()
    print(f"phase 24b: {time.perf_counter() - t0:.1f} s")


def statestore_durable(dev, card, stream, sync) -> None:
    """Phase 24d: a shadow provider over a DurableStore on the card under
    the validating notary, dropped without close() and rebuilt from its
    directory."""
    import dataclasses
    import shutil
    import tempfile

    from corda_tpu_torch.crypto import SecureHash, TransactionSignature
    from corda_tpu_torch.durability import DurableStore
    from corda_tpu_torch.node.monitoring import node_metrics
    from corda_tpu_torch.notary import InMemoryUniquenessProvider
    from corda_tpu_torch.statestore import DeviceShardedUniquenessProvider

    t0 = time.perf_counter()
    k = STATESTORE_DURABLE_WINDOWS
    stream = dataclasses.replace(stream, windows=stream.windows[:k], kinds=stream.kinds[:k])
    base = tempfile.mkdtemp(prefix="statestore-durable-")
    try:
        mem = InMemoryUniquenessProvider()
        want, _s = notary_pass(dev, stream, stream.windows, sync=sync, validating=True,
                               provider=mem)
        prov = DeviceShardedUniquenessProvider(DurableStore(base, name="notary"), device=dev,
                                               slots_per_shard=STATESTORE_NOTARY_SLOTS)
        got, _s = notary_pass(dev, stream, stream.windows, sync=sync, validating=True,
                              provider=prov)
        if [answer_of(r) for w in got for r in w] != [answer_of(r) for w in want for r in w]:
            raise AssertionError("the durable device provider's answers differ")
        del prov  # dropped without close(): a crash
        t1 = time.perf_counter()
        prov = DeviceShardedUniquenessProvider(DurableStore(base, name="notary"), device=dev,
                                               slots_per_shard=STATESTORE_NOTARY_SLOTS)
        sync()
        rebuild_s = time.perf_counter() - t1
        rec = prov.last_recovery
        if prov.consumed_digest() != mem.consumed_digest() or prov.device_divergence():
            raise AssertionError("the rebuilt consumed set differs from the oracle's")
        spent = next(stx for stx, r in zip(stream.windows[1], want[1])
                     if isinstance(r, TransactionSignature))
        c = node_metrics().counter("statestore.probe_rows").count
        conflict = prov.commit_batch([(list(spent.inputs),
                                       SecureHash(hashlib.sha256(b"mallory-24d").digest()),
                                       "mallory")])[0]
        probed = node_metrics().counter("statestore.probe_rows").count - c
        if conflict is None or not probed or prov.spill_count():
            raise AssertionError("the rebuilt provider's device probe did not refuse a double "
                                 "spend")
        rows = prov.table_stats()["live_rows"]
        prov.close()
        print(f"statestore durable: {sum(len(w) for w in stream.windows)} requests ({k} windows) "
              f"through the validating notary over a shadow provider on a DurableStore, dropped "
              f"without close(); rebuilt from the directory in {rebuild_s:.3f} s ({rec.replayed} "
              f"records replayed, {rows} rows loaded onto the card): consumed_digest == the "
              f"never-crashed in-memory oracle's, a double spend of a recovered ref refused by a "
              f"device probe  [{card}]")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    print(f"phase 24d: {time.perf_counter() - t0:.1f} s")


def statestore_vault(dev, card) -> None:
    """Phase 24e: a mock network on the card with the gate on, so every
    node's vault keeps its unconsumed-ref index on the card; Cash issues and
    payments; each index against its vault's SQL answer."""
    from corda_tpu_torch.finance import CashIssueFlow, CashPaymentFlow, CashState
    from corda_tpu_torch.node import QueryCriteria, StateStatus
    from corda_tpu_torch.statestore import configure_statestore
    from corda_tpu_torch.testing.mocknet import MockNetworkNodes

    t0 = time.perf_counter()
    configure_statestore(enabled=True, slots_per_shard=VAULT_INDEX_SLOTS)
    net = MockNetworkNodes(device=dev)
    try:
        alice = net.create_node("Index Alice")
        bob = net.create_node("Index Bob")
        notary = net.create_notary_node("Notary", batched=True, max_batch=NOTARY_WINDOW,
                                        window_s=STORM_WINDOW_S)
        for qty in (300, 500, 700):
            alice.run_flow(CashIssueFlow(qty, "GBP", b"\x24", notary.party), timeout=120)
        alice.run_flow(CashPaymentFlow(600, "GBP", bob.party), timeout=120)
        bob.run_flow(CashPaymentFlow(100, "GBP", alice.party), timeout=120)
        seen = {}
        for node in (alice, bob):
            vault = node.services.vault_service
            index = vault._state_index
            if index is None or index._table.device != dev:
                raise AssertionError(f"{node.party.name}: no index on the card")
            live = vault.unconsumed_states(CashState)
            spent = vault.query_by(QueryCriteria(status=StateStatus.CONSUMED,
                                                 contract_state_types=(CashState,))).states
            refs = [sr.ref for sr in live] + [sr.ref for sr in spent]
            bits = index.contains(refs).tolist()
            sql = [vault.unconsumed_ref_exists(ref) for ref in refs]
            mine = sum(sr.state.data.owner.owning_key == node.party.owning_key for sr in live)
            if bits != [True] * len(live) + [False] * len(spent) or bits != sql:
                raise AssertionError(f"{node.party.name}: the index's membership {bits} != "
                                     f"the SQL answer")
            if index.owner_count(node.party.owning_key) != mine:
                raise AssertionError(f"{node.party.name}: owner_count "
                                     f"{index.owner_count(node.party.owning_key)} != {mine}")
            seen[str(node.party.name)] = (len(live), len(spent), mine)
        print(f"statestore vault index: a mock network on the card with CORDA_TPU_STATESTORE on "
              f"({VAULT_INDEX_SLOTS} slots an index): three issues and two payments; each "
              f"node's index contains its unconsumed Cash refs and none of its consumed ones, "
              f"== unconsumed_ref_exists, and owner_count == its own live states; (live, "
              f"consumed, own) {seen}")
    finally:
        net.stop()
        configure_statestore(enabled=False)
        from corda_tpu_torch.serving import shutdown_scheduler

        shutdown_scheduler()
    print(f"phase 24e: {time.perf_counter() - t0:.1f} s")


def statestore_phase(dev, card, int_rate, stream, sync=None) -> dict:
    """Phase 24: the device state store. (a) kernels I, J and K against their
    plain versions; then, with every launch counter zeroed, the main path:
    (b) the notary stream, (c) scale, (d) durable, (e) the vault index.
    Returns {name: (launches, ms, plain ms, bound, max_abs_err)}."""
    import torch

    sync = sync or torch.cuda.synchronize
    t0 = time.perf_counter()
    print_ptxas("kernels I, J, K", ("statestore",))
    err_a = hold_statestore_kernels(dev, card)
    kernels = phase_kernels()
    for k in kernels:
        k.launches = 0
    statestore_notary(dev, card, stream, sync)
    scale = statestore_scale(dev, card, int_rate, sync)
    statestore_durable(dev, card, stream, sync)
    statestore_vault(dev, card)
    launches = {k.__name__: k.launches for k in kernels}
    ss_names = [k.__name__ for k in statestore_kernels()]
    if min(launches[k] for k in ss_names) == 0:
        raise AssertionError(f"phase 24's main path missed a state store kernel: {launches}")
    print(f"phase 24: launches {launches}")
    print(f"phase 24: {time.perf_counter() - t0:.1f} s")
    return {name: (launches[name], *scale[name][:3], max(err_a, scale[name][3]))
            for name in ss_names}


EXIT_PROBE = """
import sys, time
import torch
from corda_tpu_torch.crypto import PublicKey
from corda_tpu_torch.ops.ed25519_ladder import ed25519_verify_ladder
from corda_tpu_torch.serving import device_scheduler
from corda_tpu_torch.testing import signed_triples
sched = device_scheduler()
rows = [(PublicKey(4, pk), s, m) for pk, s, m in signed_triples(64, seed=3)]
sched.submit_rows(rows).result(timeout=600)  # built and warm
rows = rows * (int(sys.argv[1]) // len(rows))
futs = [sched.submit_rows(rows) for _ in range(4)]
print("in flight", sum(not f.done() for f in futs), "of", len(futs),
      "launches", ed25519_verify_ladder.launches, flush=True)
"""


def exit_probe(card) -> None:
    """A process that submits ed25519 rows to the card's shared scheduler
    and exits with its batches in flight: rc 0, no abort."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", EXIT_PROBE, str(EXIT_PROBE_ROWS)],
                          env=oop_worker_env(), capture_output=True, text=True, timeout=600)
    if proc.returncode != 0 or "terminate called" in proc.stderr:
        raise AssertionError(f"the exit probe: rc {proc.returncode}, {proc.stderr[-2000:]}")
    print(f"exit probe: a process with {EXIT_PROBE_ROWS} x 4 rows submitted to the card's "
          f"scheduler exits at once ({proc.stdout.strip()}): rc 0, no 'terminate called' "
          f"({time.perf_counter() - t0:.1f} s)  [{card}]")


LAYER_FLOW_PAYMENTS = 4      # 25a: payments between two nodes with every layer on
LAYER_SAMPLE_S = 0.8         # 25a: the sampler's live run, as the reference's budget test
QUEUE_MESSAGES = 1500        # 25a: the native queue's throughput run, as the reference's
LOCK_OPS = 2000              # 25a: rounds of each primitive timed off and installed
HARNESS_STEP_S = 3.0         # 25b: seconds a step (the reference's 5, cut for the script's time)
# the flight dump's kinds, the reference's
FLIGHT_KINDS = ("header", "metrics", "devices", "slo", "timeline", "resilience", "durability",
                "flowprof", "sampler", "net", "contention", "causal")
LAYER_SECTIONS = ("net", "flowprof", "contention", "cluster", "slo", "timeline")


def layer_modules():
    """The port's host observability layers, by module (a package attribute
    such as ``observability.contention`` names a function)."""
    import importlib

    names = {"netstats": "messaging.netstats", "flowprof": "observability.flowprof",
             "contention": "observability.contention", "cluster": "observability.cluster",
             "slo": "observability.slo", "timeseries": "observability.timeseries",
             "sampler": "observability.sampler", "devicemon": "observability.devicemon",
             "exposition": "observability.exposition", "monitoring": "node.monitoring",
             "native_queue": "messaging.native_queue", "queue": "messaging.queue"}
    return {k: importlib.import_module(f"corda_tpu_torch.{v}") for k, v in names.items()}


def layers_on(L) -> None:
    """25a's instrumented pass: netstats, flowprof, contention (installed),
    cluster, the SLO monitor (an objective on the SERVICE class) and the
    timeline (its sampling thread at 0.25 s) on."""
    L["netstats"].configure_netstats(enabled=True, reset=True)
    L["flowprof"].configure_flowprof(enabled=True, reset=True)
    L["contention"].configure_contention(enabled=True, reset=True)
    L["contention"].install()
    L["cluster"].configure_cluster(enabled=True, reset=True)
    L["slo"].configure_slo(enabled=True, reset=True, breach_handler=None, objectives=[
        L["slo"].SLOObjective("storm", priority="service", p99_s=10.0, min_samples=20)])
    L["timeseries"].configure_timeline(enabled=True, reset=True, cadence_s=0.25)


def layers_off(L) -> None:
    L["contention"].uninstall()
    L["contention"].configure_contention(enabled=False, reset=True)
    L["netstats"].configure_netstats(enabled=False, reset=True)
    L["flowprof"].configure_flowprof(enabled=False, reset=True)
    L["cluster"].configure_cluster(enabled=False, reset=True)
    L["slo"].configure_slo(enabled=False, reset=True, objectives=())
    L["timeseries"].configure_timeline(enabled=False, reset=True)
    L["sampler"].configure_sampler(enabled=False, reset=True)


def layer_flows(dev, n=LAYER_FLOW_PAYMENTS) -> None:
    """Payments between two nodes of a mock network on the card through a
    batched notary node: the traffic the flow, network and cluster layers
    record."""
    from corda_tpu_torch.finance import CashIssueFlow, CashPaymentFlow
    from corda_tpu_torch.testing.mocknet import MockNetworkNodes

    with MockNetworkNodes(device=dev) as net:
        alice = net.create_node("Layer Alice")
        bob = net.create_node("Layer Bob")
        notary = net.create_notary_node("Layer Notary", batched=True, max_batch=NOTARY_WINDOW,
                                        window_s=STORM_WINDOW_S)
        alice.run_flow(CashIssueFlow(100 * n, "GBP", b"\x25", notary.party), timeout=120)
        for _ in range(n):
            alice.run_flow(CashPaymentFlow(10, "GBP", bob.party), timeout=120)


def sampler_overhead(L, classify: bool) -> tuple:
    """The reference's sampler budget run (``tests/test_flowprof.py``): a
    live 100 Hz sampler over three busy ``flow-worker`` threads for 0.8 s;
    (overhead ratio, samples, classified)."""
    stop = threading.Event()

    def busy():
        x = 0
        while not stop.is_set():
            x = (x + 1) % 1000003

    workers = [threading.Thread(target=busy, name=f"flow-worker-{i}", daemon=True)
               for i in range(3)]
    for w in workers:
        w.start()
    s = L["sampler"].StackSampler(hz=100)
    s._classify_cfg = classify
    s.start()
    try:
        time.sleep(LAYER_SAMPLE_S)
        ratio = s.overhead_ratio()
        dump = s.dump(top_n=10)
    finally:
        s.stop()
        stop.set()
        for w in workers:
            w.join(timeout=5)
    return ratio, dump["samples"], dump["classified"]


def lock_costs(n=LOCK_OPS) -> list:
    """Microseconds a lock acquire and release, a ``Future``'s set and
    result, and a ``queue.Queue`` put and get, each over ``n`` rounds on one
    thread: what the contention layer's timed locks add to each."""
    import queue as _queue
    from concurrent.futures import Future

    lock, q = threading.Lock(), _queue.Queue()
    out = []
    for op in ((lambda: lock.acquire() and lock.release()),
               (lambda: Future().set_result(1)),
               (lambda: (q.put(1), q.get()))):
        t0 = time.perf_counter()
        for _ in range(n):
            op()
        out.append((time.perf_counter() - t0) / n * 1e6)
    return out


def queue_throughput(L, directory: str, n=QUEUE_MESSAGES) -> tuple:
    """The reference's queue throughput run (``tests/test_native_queue.py``):
    ``n`` 200-byte publishes, then ``n`` consumes and acks, through the
    SQLite broker and the native engine, each over a file; seconds each."""
    import os

    def pump(broker) -> float:
        t0 = time.perf_counter()
        for i in range(n):
            broker.publish("q", b"x" * 200, msg_id=f"m{i}")
        for _ in range(n):
            msg = broker.consume("q", timeout=1)
            broker.ack(msg.msg_id)
        return time.perf_counter() - t0

    sql = L["queue"].DurableQueueBroker(os.path.join(directory, "sql.db"))
    t_sql = pump(sql)
    sql.close()
    nat = L["native_queue"].NativeQueueBroker(os.path.join(directory, "nat.journal"))
    t_nat = pump(nat)
    nat.close()
    return t_sql, t_nat


def layers_cost_phase(dev, card, stream, sync) -> dict:
    """Phase 25a: the storm of 19a twice through ``request()`` on the card,
    every layer off, then netstats, flowprof, contention (installed),
    cluster, the SLO monitor and the timeline on; the answers request for
    request, each layer's section, the exposition and a flight dump; then
    contention's cost an operation and the sampler's and the native
    queue's budget runs. Returns the launches of both passes."""
    import shutil
    import tempfile

    from corda_tpu_torch.ledger import ComponentGroupType
    from corda_tpu_torch.testing import state_resolver

    L = layer_modules()
    kernels = phase_kernels()
    stxs = [stx for w in stream.windows for stx in w]
    for stx in stxs:
        for g in ComponentGroupType:
            stx.tx.component_bytes(g)
    kinds = {id(stx): k for stx, k in zip(stxs, (k for w in stream.kinds for k in w))}
    commits = {i: k == "signed" for i, k in kinds.items()}
    resolve = state_resolver(stream.issue.tx)
    per_pass = len(stxs) // (STORM_INJECTORS * STORM_CHUNK) * STORM_INJECTORS * STORM_CHUNK
    n_signed = sum(commits[id(stx)] for stx in stxs[:per_pass])
    # a warm-up pass over two windows, as 19a's first
    storm_pass(dev, stream, stxs[: 2 * NOTARY_WINDOW], resolve, commits, sync)[0].svc.shutdown()
    for k in kernels:
        k.launches = 0
    passes = {}
    flight_dir = tempfile.mkdtemp(prefix="corda-layers-")
    try:
        for mode in ("off", "on"):
            if mode == "on":
                layers_on(L)
            slo = L["slo"].active_slo()
            notary, _m, secs = storm_pass(dev, stream, stxs, resolve, commits, sync, slo=slo)
            answers = check_storm(notary, kinds, dev)
            notary.svc.shutdown()
            lat = notary.latencies_ms()
            passes[mode] = {
                "answers": {id(stx): storm_answer(r) for stx, r in zip(notary.requests, answers)},
                "rate": n_signed / secs, "p50": lat[len(lat) // 2],
                "p99": lat[int(len(lat) * 0.99)], "n": len(answers)}
        if passes["on"]["answers"] != passes["off"]["answers"]:
            bad = [i for i, a in passes["off"]["answers"].items()
                   if passes["on"]["answers"].get(i) != a]
            raise AssertionError(f"{len(bad)} requests answered differently with the layers on")
        launches = {k.__name__: k.launches for k in kernels}
        must = ("ed25519_challenge", "ed25519_verify_ladder", "sha256_leaves",
                "sha256_merkle_sweep", "ed25519_comb")
        if min(launches[k] for k in must) == 0:
            raise AssertionError(f"phase 25a's launches: {launches}")
        off, on = passes["off"], passes["on"]
        print(f"layers, 19a's storm ({per_pass} requests, {n_signed} commit, B8): every answer "
              f"equal with the layers off and on, signature bytes and conflicts included "
              f"({on['n']} requests); launches {launches}")
        print(f"layers' cost on the storm: off {off['rate']:.0f} notarised tx/s, p50 "
              f"{off['p50']:.1f} ms, p99 {off['p99']:.1f} ms; on (netstats, flowprof, contention "
              f"installed, cluster, SLO, timeline) {on['rate']:.0f} tx/s, p50 {on['p50']:.1f} "
              f"ms, p99 {on['p99']:.1f} ms ({on['rate'] / off['rate']:.3f}x the rate)  [{card}]")

        # flows with every layer on: the traffic flowprof, net and cluster record
        t0 = time.perf_counter()
        layer_flows(dev)
        flows_s = time.perf_counter() - t0
        L["slo"].active_slo().evaluate()
        L["timeseries"].timeline().tick()
        snap = L["monitoring"].monitoring_snapshot()
        for name in LAYER_SECTIONS:
            sec = snap[name]
            if sec.get("enabled") is not True:
                raise AssertionError(f"the {name} section reads {sec}")
        filled = {"net": len(snap["net"]["edges"]),
                  "flowprof": snap["flowprof"]["flows"],
                  "contention": len(snap["contention"]["sites"]),
                  "cluster": snap["cluster"]["hops"],
                  "slo": sum(o.get("samples", 0) for o in snap["slo"]["objectives"]),
                  "timeline": snap["timeline"]["ticks"]}
        if min(filled.values()) == 0:
            raise AssertionError(f"a layer that was on recorded nothing: {filled}")
        print(f"layers: {LAYER_FLOW_PAYMENTS} payments with every layer on ({flows_s:.1f} s); "
              f"each section enabled and filled: edges {filled['net']}, flows "
              f"{filled['flowprof']}, lock sites {filled['contention']}, hops "
              f"{filled['cluster']}, SLO samples {filled['slo']}, timeline ticks "
              f"{filled['timeline']}")
        text = L["exposition"].metrics_text()
        parsed = L["exposition"].parse_prometheus(text)
        families = {f: sum(1 for n in parsed["__types__"] if n.startswith(f))
                    for f in ("cordatpu_net_", "cordatpu_slo_", "cordatpu_contention_")}
        if min(families.values()) == 0:
            raise AssertionError(f"metrics_text lacks a family: {families}")
        path = L["slo"].flight_dump(f"{flight_dir}/flight.jsonl", reason="phase 25a")
        with open(path) as f:
            dumped = [json.loads(line)["kind"] for line in f]
        missing = [k for k in FLIGHT_KINDS if k not in dumped]
        if missing:
            raise AssertionError(f"the flight dump's kinds: {sorted(set(dumped))}")
        print(f"layers: metrics_text {len(text.splitlines())} lines, every one parsed, "
              f"families {families}; flight dump of {len(dumped)} lines with every kind the "
              f"reference writes")
    finally:
        layers_off(L)
        shutil.rmtree(flight_dir, ignore_errors=True)
    if L["contention"].installed() or threading.Lock is not L["contention"]._REAL_LOCK:
        raise AssertionError("contention left installed")

    off = lock_costs()
    L["contention"].configure_contention(enabled=True, reset=True)
    L["contention"].install()
    try:
        on = lock_costs()
    finally:
        layers_off(L)
    print("contention's cost, microseconds an operation off / installed: "
          + ", ".join(f"{name} {a:.2f} / {b:.2f}" for name, a, b in zip(
              ("lock acquire and release", "Future made and set", "Queue put and get"), off, on))
          + f"  [{card}]")
    budgets = {}
    for classify in (False, True):
        ratio, samples, classified = sampler_overhead(L, classify)
        budgets[classify] = ratio
        print(f"sampler at 100 Hz over three busy threads, {LAYER_SAMPLE_S} s, classifier "
              f"{'on' if classified else 'off'}: overhead {ratio:.4f} of the wall (the "
              f"reference's budget 0.03), {samples} samples  [{card}]")
    qdir = tempfile.mkdtemp(prefix="corda-queue-")
    try:
        t_sql, t_nat = queue_throughput(L, qdir)
    finally:
        shutil.rmtree(qdir, ignore_errors=True)
    print(f"queues, {QUEUE_MESSAGES} publishes then consumes and acks over a file: SQLite "
          f"{t_sql * 1e3:.1f} ms, native {t_nat * 1e3:.1f} ms ({t_sql / t_nat:.1f}x; the "
          f"reference's floor 2x)  [{card}]")
    return launches


def harness_phase(dev, card) -> dict:
    """Phase 25b: the open-loop ramp (``tools.loadharness.run_harness`` at
    the reference's defaults but 3 s a step: 4, 8 and 16 qps, Cash payments,
    flowprof and netstats on) over a mock network on the card. Returns the
    launches."""
    import os
    import shutil
    import tempfile

    from corda_tpu_torch.tools.loadharness import HarnessConfig, run_harness, write_loadtest

    kernels = phase_kernels()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    result = run_harness(HarnessConfig(device=dev, step_duration_s=HARNESS_STEP_S))
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    for step in result["steps"]:
        print(f"harness step {step['qps']:g} qps: offered {step['offered']}, completed "
              f"{step['completed']}, shed {step['shed']}, error_rate {step['error_rate']:.4f}, "
              f"p50 {step['p50_s'] * 1e3:.1f} ms, p99 {step['p99_s'] * 1e3:.1f} ms, "
              f"retransmits {step['retransmits']}, transit p99 "
              f"{step['net_transit_p99_s'] * 1e3:.3f} ms, SLO "
              f"{'held' if step['slo_ok'] else 'missed'}  [{card}]")
    knee = result["knee"]
    if knee is None:
        raise AssertionError("no step of the ramp held its SLO")
    wf = knee["waterfall"]
    total = sum(wf["phases"].values())
    if not wf["flows"] or abs(total - wf["wall_s"]) > 0.05 * wf["wall_s"]:
        raise AssertionError(f"the knee's waterfall: phases {total} against wall {wf['wall_s']}")
    top = sorted(wf["shares"].items(), key=lambda kv: -kv[1])[:4]
    print(f"harness knee {knee['qps']:g} qps: p50 {knee['p50_s'] * 1e3:.1f} ms, p99 "
          f"{knee['p99_s'] * 1e3:.1f} ms; its waterfall ({wf['flows']} flows) sums to its wall "
          f"within {abs(total - wf['wall_s']) / wf['wall_s']:.2%}: "
          + ", ".join(f"{k} {v:.1%}" for k, v in top) + f"; ramp {wall:.1f} s  [{card}]")
    tmp = tempfile.mkdtemp(prefix="corda-loadtest-")
    try:
        path = write_loadtest(result, os.path.join(tmp, "LOADTEST.json"))
        gate = subprocess.run([sys.executable, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tools_perf_gate.py"), "--result", path,
                               "--check-schema"], capture_output=True, text=True, timeout=60)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if gate.returncode != 0:
        raise AssertionError(f"the schema gate: {gate.stdout[-2000:]} {gate.stderr[-2000:]}")
    if launches["ed25519_challenge"] == 0 or launches["ed25519_verify_ladder"] == 0:
        raise AssertionError(f"phase 25b's launches: {launches}")
    rose = [k for k in ("sha256_leaves", "sha256_merkle_sweep", "ed25519_comb") if launches[k]]
    print(f"harness: LOADTEST.json passes tools_perf_gate.py --check-schema; launches "
          f"{launches}; of C-E, {', '.join(rose) or 'none'} rose")
    return launches


def layers_phase(dev, card, stream, sync=None) -> dict:
    """Phase 25: 25a, then 25b."""
    import torch

    sync = sync or torch.cuda.synchronize
    t0 = time.perf_counter()
    try:
        cost = layers_cost_phase(dev, card, stream, sync)
        t1 = time.perf_counter()
        harness = harness_phase(dev, card)
    finally:
        from corda_tpu_torch.serving import shutdown_scheduler

        shutdown_scheduler()
    print(f"phase 25: 25a {t1 - t0:.1f} s, 25b {time.perf_counter() - t1:.1f} s")
    return {"cost": cost, "harness": harness}


MESH_LOGICAL = 2           # 26c: logical ordinals on the one card
MESH_SCREEN_EVERY = 4      # 26c: every fourth row's consumed digest preloaded
HEDGE_MIN_S = 0.5          # 26b: the least hedge deadline (the reference's 0.05 s, raised
                           # for a host that shares the card's machine)
STALL_S = 2.0              # 26b: the injected stall


def mesh_kernels() -> tuple:
    """The wrappers phase 26 counts."""
    from corda_tpu_torch.ops.ed25519_ladder import ed25519_verify_ladder
    from corda_tpu_torch.ops.scalar25519 import ed25519_challenge
    from corda_tpu_torch.ops.secp256_ladder import ecdsa_verify_k1, ecdsa_verify_r1
    from corda_tpu_torch.ops.sphincs_batch import sphincs_verify
    from corda_tpu_torch.ops.statestore import (
        statestore_commit,
        statestore_commit_check,
        statestore_probe,
    )

    return (ed25519_challenge, ed25519_verify_ladder, ecdsa_verify_k1, ecdsa_verify_r1,
            sphincs_verify, statestore_probe, statestore_commit_check, statestore_commit)


def counted(fn):
    """(fn's result, each phase-26 wrapper's launches while it ran), the
    counts zeroed just before."""
    import torch

    kernels = mesh_kernels()
    for k in kernels:
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k.__name__: k.launches for k in kernels}


def mesh_step_phase(dev, pool, oracle, want_plain) -> dict:
    """Phase 26a: the mesh on the card's one ordinal."""
    import numpy as np
    import torch

    from corda_tpu_torch.crypto import PublicKey, is_valid
    from corda_tpu_torch.ops.secp256 import ecdsa_verify_dispatch
    from corda_tpu_torch.parallel import mesh as M
    from corda_tpu_torch.testing import (
        MIXED_COMPOSITION,
        ecdsa_adversarial_lanes,
        mixed_rows,
        sphincs_adversarial_lanes,
    )
    from corda_tpu_torch.verifier import dispatch_signature_rows

    if M.visible_devices() != [dev]:
        raise AssertionError(f"the mesh sees {M.visible_devices()}, not the one card")
    mv = M.MeshVerifier(M.make_mesh())
    pks, sigs, msgs = (list(x) for x in zip(*pool))
    n = len(pool)
    spent = np.random.default_rng(26).integers(-2**31, 2**31, size=(n, 8),
                                               dtype=np.int64).astype(np.int32)
    (mask, none1, none2), _ = counted(lambda: mv.dispatch_rows(pks, sigs, msgs))
    (mask2, spent_all, total), launches = counted(
        lambda: mv.dispatch_rows(pks, sigs, msgs, spent_hashes=spent))
    got = mask.cpu().numpy()
    got2 = mask2.cpu().numpy()
    sa = spent_all.cpu().numpy()
    if none1 is not None or none2 is not None:
        raise AssertionError("the mask-only step gathered")
    if got[:n].tolist() != oracle.tolist() or got2[:n].tolist() != oracle.tolist():
        raise AssertionError("the mesh's mask != the oracle")
    if got[:n].tolist() != want_plain.tolist() or got[n:].any():
        raise AssertionError("the mesh's mask != the plain ladder's")
    if not (sa[:n] == spent).all() or sa[n:].any() or sa.shape != (got2.shape[0], 8):
        raise AssertionError("the gathered spent rows != the rows given")
    if int(total) != int(got2[:n].sum()):
        raise AssertionError(f"the psum'd total {int(total)} != the mask's {int(got2.sum())}")
    if min(launches["ed25519_challenge"], launches["ed25519_verify_ladder"]) == 0:
        raise AssertionError(f"the sharded step missed A or B: {launches}")
    print(f"26a: dispatch_rows on the card's one ordinal, {n} rows (every adversarial kind) "
          f"padded to {got.shape[0]}: mask == oracle == plain, with and without the spent "
          f"rows; spent_all == the rows given, total {int(total)} == the mask's count")
    ec = {}
    for sid, curve in ((2, "secp256k1"), (3, "secp256r1")):
        lanes = ecdsa_adversarial_lanes(curve, seed=26)
        kp, ks, km = ([x[i] for x in lanes] for i in (1, 2, 3))
        m = mv.dispatch_ecdsa_rows(curve, kp, ks, km).cpu().numpy()[:len(lanes)]
        one = ecdsa_verify_dispatch(curve, kp, ks, km, device=dev).cpu().numpy()[:len(lanes)]
        want = [is_valid(PublicKey(sid, pk), s, msg) for pk, s, msg in zip(kp, ks, km)]
        if m.tolist() != want or one.tolist() != want:
            raise AssertionError(f"dispatch_ecdsa_rows {curve} != the oracle")
        ec[curve] = (len(lanes), int(m.sum()))
    lanes = sphincs_adversarial_lanes(26)
    sp, ss, sm = ([x[i] for x in lanes] for i in (1, 2, 3))
    chunked = mv.dispatch_sphincs_rows(sp, ss, sm)
    got_s = np.asarray(chunked)
    want_s = [is_valid(PublicKey(5, pk), s, msg) for pk, s, msg in zip(sp, ss, sm)]
    if got_s.tolist() != want_s:
        raise AssertionError("dispatch_sphincs_rows != the oracle")
    print(f"26a: dispatch_ecdsa_rows == oracle on {ec} (lanes, accepted); "
          f"dispatch_sphincs_rows == oracle on {len(lanes)} lanes in {len(chunked.parts)} "
          f"chunk(s), {int(got_s.sum())} accepted")
    # phase 10's composition through dispatch_signature_rows, the mesh forced
    if MIXED_DISTINCT:
        rows = list(MIXED_DISTINCT)
        want_m = [MIXED_DISTINCT[r] for r in rows]
    else:
        rows = mixed_rows(MIXED_COMPOSITION, keys_per_scheme=16, seed=26, device=dev)
        want_m = [is_valid(*r) for r in rows]
    M.enable_service_mesh(True)
    try:
        pending, mixed_launches = counted(lambda: dispatch_signature_rows(rows))
        got_m = pending.collect()
    finally:
        M.enable_service_mesh(None)
    if got_m.tolist() != want_m:
        raise AssertionError("dispatch_signature_rows through the mesh != the oracle")
    need = ("ed25519_challenge", "ed25519_verify_ladder", "ecdsa_verify_k1", "ecdsa_verify_r1",
            "sphincs_verify")
    if min(mixed_launches[k] for k in need) == 0:
        raise AssertionError(f"the mesh's mixed dispatch missed a kernel: {mixed_launches}")
    n_host = sum(k.scheme_id == 1 for k, _s, _m in rows)
    if pending.device_rows != len(rows) - n_host:
        raise AssertionError(f"device rows {pending.device_rows} of {len(rows)}")
    print(f"26a: dispatch_signature_rows with the service mesh on, {len(rows)} rows of "
          f"MIXED_COMPOSITION: every verdict == oracle, {pending.device_rows} device rows; "
          f"launches {mixed_launches}")
    return {"launches": {k: mixed_launches[k] + launches.get(k, 0) for k in need}}


def resilience_phase(dev, pool, oracle) -> dict:
    """Phase 26b: the striped scheduler with the resilience policy on."""
    from corda_tpu_torch import faultinject as fi
    from corda_tpu_torch.crypto import PublicKey
    from corda_tpu_torch.node.monitoring import node_metrics
    from corda_tpu_torch.serving import DeviceScheduler, ResiliencePolicy, ShapeTable

    names = ("serving.hedge.fired", "serving.hedge.won_host", "serving.hedge.won_device",
             "serving.hedge.won_sibling", "serving.hedge.discarded", "serving.device_failover",
             "serving.redispatch", "serving.breaker.opened", "serving.breaker.closed",
             "serving.breaker.probes", "serving.breaker.host_routed", "serving.mesh.striped",
             "serving.quarantine.strikes", "verifier.device_failover", "verifier.host_shed",
             "serving.hedge.device_error")

    def snap():
        m = node_metrics().snapshot()
        return {k: m.get(k, {}).get("count", 0) for k in names}

    def delta(before):
        after = snap()
        return {k: after[k] - before[k] for k in names}

    rows = [(PublicKey(4, pk), s, m) for pk, s, m in pool]
    pol = ResiliencePolicy(hedge_min_s=HEDGE_MIN_S, hedge_max_s=10.0, breaker_threshold=2,
                           breaker_backoff_s=0.5, redispatch_limit=1, probe_backoff_s=0.5,
                           flight_dump_on_quarantine=False)
    # no request fills its bucket, so every verdict is the cofactorless oracle's
    sched = DeviceScheduler(device=dev, mesh=True, megabatch_fill=9.9, resilience=pol,
                            shapes=ShapeTable({"buckets": [128, 2048], "source": "phase 26b"}))
    out = {}
    try:
        def serve(sizes, offset=0):
            futs, wants = [], []
            for size in sizes:
                idx = [(offset + i) % len(rows) for i in range(size)]
                futs.append(sched.submit_rows([rows[i] for i in idx]))
                wants.append([bool(oracle[i]) for i in idx])
                offset += size
            got = [f.result(timeout=300) for f in futs]
            for rr, want in zip(got, wants):
                if rr.mask.tolist() != want:
                    raise AssertionError("26b: a verdict != the oracle")
            return got

        # the clean pass: each shape warms, then runs hedged
        before = snap()
        shed0 = sched.counters["serving.shed"]
        for _ in range(3):
            for rr in serve([16]) + serve([700, 16, 100]):
                if rr.n_device != len(rr.mask):
                    raise AssertionError("26b: a clean request did not settle on the card")
        d = delta(before)
        d["shed"] = sched.counters["serving.shed"] - shed0
        out["clean"] = d
        if d["serving.hedge.fired"] or d["serving.device_failover"] or \
                d["verifier.device_failover"] or d["shed"] or d["verifier.host_shed"] or \
                d["serving.hedge.device_error"]:
            raise AssertionError(f"26b's clean pass hedged, failed over or shed: {d}")
        # an injected stall: the hedge fires and, with no sibling, settles on the host
        before = snap()
        fi.install(fi.FaultInjector(fi.FaultPlan(
            seed=26, stall_sites=(("serving.dispatch", 1, STALL_S),))))
        try:
            rr = serve([16])[0]
        finally:
            fi.clear()
        deadline = time.monotonic() + STALL_S + 10
        while delta(before)["serving.hedge.discarded"] < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        d = delta(before)
        out["stall"] = d
        if (d["serving.hedge.fired"], d["serving.hedge.won_host"], rr.n_device,
                d["serving.hedge.discarded"]) != (1, 1, 0, 1):
            raise AssertionError(f"26b's stall pass: n_device {rr.n_device}, {d}")
        # a clean settle ends the breaker's streak the hedge's loss began
        serve([16])
        # injected dispatch faults: the breaker opens, the canary closes it
        before = snap()
        fi.install(fi.FaultInjector(fi.FaultPlan(
            seed=26, fail_sites=(("serving.dispatch", 1), ("serving.dispatch", 2)))))
        try:
            rr = serve([16])[0]
            opened = pol.breaker_for(0).state
        finally:
            fi.clear()
        deadline = time.monotonic() + 30
        while pol.breaker_for(0).state != 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        after_rr = serve([16])[0]
        d = delta(before)
        out["faults"] = d
        if (opened, rr.n_device, after_rr.n_device, d["serving.breaker.opened"],
                d["serving.breaker.closed"], d["serving.device_failover"],
                d["serving.redispatch"]) != (1, 0, 16, 1, 1, 1, 1):
            raise AssertionError(f"26b's fault pass: breaker {opened}, n_device "
                                 f"{rr.n_device} then {after_rr.n_device}, {d}")
    finally:
        sched.shutdown()
    for name, d in out.items():
        print(f"26b {name}: " + ", ".join(f"{k} {v}" for k, v in d.items()))
    return out


def striped_commit_check(dev, card, table, plain, pre, int_rate) -> dict:
    """Phase 26c: J's check kernel alone (``statestore_commit_check``) on
    each shard of the striped ``table`` over rows already present, with the
    same tx and with another, absent rows and masked rows, its whole output
    held against its plain version and the expected bits; then a striped
    ``commit_rows`` whose requests conflict on another shard than the one
    their fresh row goes to, held against the ``plain`` table (verdicts,
    overflow, every slot). ``pre`` are the preloaded rows, each its own tx.
    Returns the check kernel's line for the ``kernels`` list."""
    import numpy as np

    from corda_tpu_torch.ops import statestore as ops
    from corda_tpu_torch.ops.opcount import statestore_int_ops

    rng = np.random.default_rng(26)
    w, n_sh = table.max_probe, table.n_shards

    def fresh(n):
        return rng.integers(-2**31, 2**31, size=(n, 8), dtype=np.int64).astype(np.int32)

    def owner(rows):
        return (rows[:, 1].astype(np.int64) & 0xFFFFFFFF) % n_sh

    m = len(pre) // 4
    idx = rng.permutation(len(pre))
    same, other, masked = pre[idx[:m]], pre[idx[m:2 * m]], pre[idx[2 * m:3 * m]]
    r, k = 4 * m, 2
    q = fresh(r * k).reshape(r, k, 8)
    qtx = fresh(r)
    valid = np.ones((r, k), np.int32)
    q[:m, 0], qtx[:m] = same, same                 # present with the same tx
    q[m:2 * m, 0] = other                          # present with another tx
    q[3 * m:, 0], valid[3 * m:, 0] = masked, 0     # present but masked
    present = np.zeros((r, k), bool)
    present[:2 * m, 0] = True
    conflict = np.zeros((r, k), bool)
    conflict[m:2 * m, 0] = True
    own = owner(q.reshape(r * k, 8))
    err, got_bits = 0, np.zeros(2 * r * k, np.int64)
    for sh, (keys, txs, tags), (qd, qtxd, vd) in table._each_shard(q, qtx, valid):
        got = ops.statestore_commit_check(keys, txs, tags, qd, qtxd, vd, w, n_sh, sh)
        want = ops.statestore_commit_check_plain(keys, txs, tags, qd, qtxd, vd, w, n_sh, sh)
        err = max(err, int((got.long() - want.long()).abs().max()))
        bits = got.cpu().numpy()
        mine = own == sh
        if not ((bits[:r * k] > 0) == (present.reshape(-1) & mine)).all() or \
                not ((bits[r * k:] > 0) == (conflict.reshape(-1) & mine)).all():
            raise AssertionError(f"26c: shard {sh}'s commit check != the expected bits")
        if not bits[:r * k].any() or not bits[r * k:].any():
            raise AssertionError(f"26c: shard {sh}'s check saw no present or no conflicting row")
        got_bits += bits
    if err:
        raise AssertionError(f"26c: statestore_commit_check != its plain version ({err})")
    if int(got_bits[:r * k].sum()) != 2 * m or int(got_bits[r * k:].sum()) != m:
        raise AssertionError("26c: the shards' check bits do not sum to the rows given")
    keys, txs, tags = table._shards[0]
    qd, qtxd, vd = table._upload(q, qtx, valid, device=tags.device)
    ms = cuda_ms(lambda: ops.statestore_commit_check(keys, txs, tags, qd, qtxd, vd, w, n_sh,
                                                     0), 20)
    p_ms = plain_ms(lambda: ops.statestore_commit_check_plain(keys, txs, tags, qd, qtxd, vd, w,
                                                              n_sh, 0), 3)
    qf = qd.reshape(r * k, 8)[(vd.reshape(-1) != 0) & ops.owned(qd.reshape(r * k, 8), n_sh, 0)]
    hits = int(ops.statestore_probe_plain(keys, tags, qf, w).sum())
    b = bound(r * k * (32 + 4) + r * 32 + qf.shape[0] * 4 * w
              + 32 * ss_window_live(tags, qf, w) + 32 * hits + 4 * 2 * r * k,
              statestore_int_ops(qf.shape[0], w), int_rate)

    # a striped commit: a fresh row on one shard, a row live with another tx on the other
    live = [pre[owner(pre) == sh] for sh in range(n_sh)]
    m2 = min(64, n_sh * min(len(x) for x in live))   # each live row in one request
    pool = fresh(8 * m2)
    by_owner = [pool[owner(pool) == sh] for sh in range(n_sh)]
    q2 = fresh(2 * m2 * 2).reshape(2 * m2, 2, 8)
    for i in range(m2):
        a = i % n_sh
        q2[i, 0] = by_owner[a][i // n_sh]
        q2[i, 1] = live[(a + 1) % n_sh][i % len(live[(a + 1) % n_sh])]
    qtx2 = fresh(2 * m2)
    zeros = np.zeros(2 * m2, np.int32)
    args = (q2, qtx2, np.ones((2 * m2, 2), np.int32), zeros, zeros)
    (conf, ovf), launches = counted(lambda: table.commit_rows(*args))
    conf_p, ovf_p = plain.commit_rows(*args)
    want_conf = np.arange(2 * m2) < m2
    if not (conf == want_conf).all() or not (conf == conf_p).all() or \
            not (ovf == ovf_p).all() or ovf.any():
        raise AssertionError("26c: the striped commit's verdicts != the plain table's and "
                             "the expected")
    for got_a, want_a in zip(table.table_arrays(), plain.table_arrays()):
        if not (got_a == want_a).all():
            raise AssertionError("26c: the striped commit's table != the plain table's")
    if table.probe_rows(q2[:m2, 0]).any() or not table.probe_rows(
            q2[m2:].reshape(-1, 8)).all():
        raise AssertionError("26c: a conflicting request inserted its fresh row on its shard")
    if min(launches["statestore_commit_check"], launches["statestore_commit"]) < n_sh:
        raise AssertionError(f"26c: the striped commit missed J's check: {launches}")
    print(f"26c: statestore_commit_check on each of {n_sh} shards, {r} requests of {k} rows "
          f"({m} present with their tx, {m} with another, {m} absent, {m} masked): the whole "
          f"(2 r k,) output == its plain version and the expected bits; a striped commit of "
          f"{m2} requests conflicting on the other shard and {m2} clean ones == the plain "
          f"table (verdicts, overflow, every slot), no conflicting fresh row inserted; "
          f"launches {launches}; the check {ms:.4f} ms on one shard (plain {p_ms:.3f} ms), "
          f"bound {b[0]:.6f} ms by {b[1]}  [{card}]")
    return {"launches": launches["statestore_commit_check"], "max_abs_err": err, "ms": ms,
            "plain_ms": p_ms, "bound_ms": b[0], "bound_by": b[1]}


def mega_phase(dev, card, pool, oracle) -> dict:
    """Phase 26c: the mega-batch on two logical ordinals of the card."""
    import types

    import numpy as np
    import torch

    from corda_tpu_torch.crypto import PublicKey
    from corda_tpu_torch.node.monitoring import node_metrics
    from corda_tpu_torch.parallel import mesh as M
    from corda_tpu_torch.serving import DeviceScheduler, ShapeTable
    from corda_tpu_torch.serving.scheduler import _consumed_rows
    from corda_tpu_torch.statestore import DeviceShardedTable, DeviceShardedUniquenessProvider
    from corda_tpu_torch.ops.opcount import HBM_BYTES_PER_S

    rows = [(PublicKey(4, pk), s, m) for pk, s, m in pool]
    n = len(rows)
    digests = _consumed_rows([m for _k, _s, m in rows])
    pre = np.unique(digests[::MESH_SCREEN_EVERY], axis=0)
    pre_set = {r.tobytes() for r in pre}
    host_hits = sum(r.tobytes() in pre_set for r in digests)

    def hits():
        return node_metrics().snapshot().get("statestore.mega_probe_hits", {}).get("count", 0)

    M.set_logical_devices([dev] * MESH_LOGICAL)
    sched = provider = None
    try:
        mesh = M.make_mesh()
        provider = DeviceShardedUniquenessProvider(mesh=mesh, slots_per_shard=2**13,
                                                   max_probe=32)
        table = provider._table
        _, pre_launches = counted(lambda: table.insert_rows(pre, pre))
        # the striped preload against the plain versions' table on the CPU
        plain = DeviceShardedTable(mesh=types.SimpleNamespace(
            devices=[torch.device("cpu")] * MESH_LOGICAL), slots_per_shard=2**13, max_probe=32,
            name="phase 26c plain")
        plain.insert_rows(pre, pre)
        for got, want in zip(table.table_arrays(), plain.table_arrays()):
            if not (got == want).all():
                raise AssertionError("26c: the striped table != its plain versions' table")
        check = striped_commit_check(dev, card, table, plain, pre, card_rates()[2])
        plain.close()
        if min(pre_launches["statestore_commit_check"], pre_launches["statestore_commit"]) == 0:
            raise AssertionError(f"26c: the striped preload missed J: {pre_launches}")
        sched = DeviceScheduler(device=dev, mesh=True, megabatch_fill=0.0,
                                shapes=ShapeTable({"buckets": [n], "source": "phase 26c"}))
        before = node_metrics().snapshot()
        hits0 = hits()
        rr, launches = counted(lambda: sched.submit_rows(rows).result(timeout=300))
        mega_hits = hits() - hits0
        after = node_metrics().snapshot()
        if after.get("serving.mesh.megabatch", {}).get("count", 0) - \
                before.get("serving.mesh.megabatch", {}).get("count", 0) != 1:
            raise AssertionError("26c: the batch did not fuse into a mega-batch")
        if rr.mask.tolist() != oracle.tolist() or rr.n_device != n or rr.device is not None:
            raise AssertionError("26c: the mega-batch's verdicts != the oracle")
        if mega_hits != host_hits:
            raise AssertionError(f"26c: the screen counted {mega_hits}, the host {host_hits}")
        if min(launches["ed25519_challenge"], launches["ed25519_verify_ladder"],
               launches["statestore_probe"]) < MESH_LOGICAL:
            raise AssertionError(f"26c: the mega-batch missed a kernel: {launches}")
        # the step alone: the gather onto each ordinal and the psum
        keys = [k.encoded for k, _s, _m in rows]
        sigs = [s for _k, s, _m in rows]
        msgs = [m for _k, _s, m in rows]
        mv = sched._mesh_verifier
        mask, spent_all, total = mv.dispatch_rows(keys, sigs, msgs, min_bucket=n,
                                                  spent_hashes=digests)
        b = int(mask.shape[0])
        copies = [c.cpu().numpy() for c in mv.spent_all_by_ordinal]
        if len(copies) != MESH_LOGICAL or any((c[:n] != digests).any() or c[n:].any()
                                              for c in copies):
            raise AssertionError("26c: an ordinal's gathered rows != the host's digests")
        if int(total) != int(oracle.sum()):
            raise AssertionError(f"26c: psum'd total {int(total)} != {int(oracle.sum())}")
        step_ms = plain_ms(lambda: mv.dispatch_rows(keys, sigs, msgs, min_bucket=n,
                                                    spent_hashes=digests), 3)
        parts = [spent_all[lo:hi] for lo, hi in M.shard_bounds(mesh, b)]
        gather_ms = cuda_ms(lambda: [M._gather(parts, d) for d in mesh.devices], 50)
        gather_bytes = MESH_LOGICAL * 2 * b * 8 * 4
        bound_ms = gather_bytes / HBM_BYTES_PER_S * 1e3
    finally:
        M.set_logical_devices(None)
        if sched is not None:
            sched.shutdown()
        if provider is not None:
            provider.close()
    print(f"26c: one mega-batch of {n} rows on {MESH_LOGICAL} logical ordinals of the card: "
          f"every verdict == oracle, the screen (kernel I a shard) counted {mega_hits} == the "
          f"host's {host_hits} over {len(pre)} preloaded rows (the striped preload == its "
          f"plain versions'); each ordinal's gathered rows == the host's digests, total "
          f"{int(total)}; launches {launches}")
    return {"launches": launches, "step_ms": step_ms, "gather_ms": gather_ms,
            "bound_ms": bound_ms, "gather_bytes": gather_bytes, "b": b, "check": check}


def profiler_phase(dev, pool) -> dict:
    """Phase 26d: the profiler and devicemon on."""
    from corda_tpu_torch.crypto import PublicKey
    from corda_tpu_torch.node.monitoring import monitoring_snapshot
    from corda_tpu_torch.observability import configure_devicemon, devicemon
    from corda_tpu_torch.observability.profiler import configure_profiler, profiler
    from corda_tpu_torch.ops.ed25519 import ed25519_verify_dispatch
    from corda_tpu_torch.ops.ed25519_ladder import ed25519_verify_ladder
    from corda_tpu_torch.ops.ed25519_sign import ed25519_sign_dispatch
    from corda_tpu_torch.ops.secp256 import ecdsa_verify_dispatch
    from corda_tpu_torch.ops.sha256 import sha256_batch_words
    from corda_tpu_torch.ops.sphincs_batch import sphincs_verify_dispatch
    from corda_tpu_torch.ops.txid import compute_tx_ids
    from corda_tpu_torch.serving import DeviceScheduler
    from corda_tpu_torch.testing import (
        GeneratedLedger,
        ecdsa_adversarial_lanes,
        sphincs_adversarial_lanes,
    )

    pks, sigs, msgs = (list(x) for x in zip(*pool[:512]))
    ec = ecdsa_adversarial_lanes("secp256k1", seed=27)
    sp = sphincs_adversarial_lanes(27)[:8]
    wtxs = [stx.tx for stx in GeneratedLedger(seed=26, device=dev).generate(64).values()]
    seeds = [hashlib.sha256(b"26d %d" % i).digest() for i in range(64)]
    calls = (
        lambda: ed25519_verify_dispatch(pks, sigs, msgs, device=dev).cpu(),
        lambda: sha256_batch_words(msgs, device=dev).cpu(),
        lambda: compute_tx_ids(wtxs, device=dev),
        lambda: ed25519_sign_dispatch(seeds, msgs[:64], device=dev).collect(),
        lambda: ecdsa_verify_dispatch("secp256k1", *([x[i] for x in ec] for i in (1, 2, 3)),
                                      device=dev).cpu(),
        lambda: sphincs_verify_dispatch(*([x[i] for x in sp] for i in (1, 2, 3)),
                                        device=dev).cpu(),
    )
    configure_profiler(enabled=True, reset=True)
    configure_devicemon(enabled=True, reset=True)
    sched = DeviceScheduler(device=dev)
    try:
        for _ in range(3):
            for call in calls:
                call()
        ed25519_verify_ladder.launches = 0
        rows = [(PublicKey(4, pk), s, m) for pk, s, m in zip(pks, sigs, msgs)]
        batches = 4
        for k in range(batches):
            sched.submit_rows(rows[k * 100:(k + 1) * 100]).result(timeout=120)
        b_launches = ed25519_verify_ladder.launches
        mon = devicemon().snapshot()["devices"]["0"]
        snap = profiler().snapshot()["kernels"]
        mon_snap = monitoring_snapshot()
    finally:
        sched.shutdown()
        configure_profiler(enabled=False)
        configure_devicemon(enabled=False, reset=True)
    names = {"A": "sha512", "B": "ed25519.verify", "C": "sha256", "D": "txid",
             "E": "ed25519.sign", "F": "ecdsa.verify", "H": "sphincs.verify"}
    out = {}
    for letter, name in names.items():
        k = snap.get(name)
        if k is None:
            raise AssertionError(f"26d: the profiler has no {name} ({letter})")
        for bucket, b in k["buckets"].items():
            if b["compile_count"] != 1 or b["execute_count"] < 2:
                raise AssertionError(f"26d: {name} x {bucket}: {b}")
            out[f"{letter} {name} x {bucket}"] = (b["compile_s"] * 1e3,
                                                  b["execute_mean_s"] * 1e3)
    if mon["dispatches"] != b_launches or b_launches != batches:
        raise AssertionError(f"26d: devicemon's dispatches {mon['dispatches']}, kernel B's "
                             f"launches {b_launches}, batches {batches}")
    if "resilience" not in mon_snap or not mon_snap.get("profiler"):
        raise AssertionError("26d: monitoring_snapshot lacks its resilience or profiler section")
    # what each key's event pair brackets: the whole entry point, so host
    # prep that runs between the events (the card idle) counts, and B's
    # pair holds A's
    scope = {"A": "kernel A's launch", "B": "the dispatch: host prep, A and B",
             "C": "the dispatch: host packing and C", "D": "the ids: host prep, C and D",
             "E": "the dispatch: host prep and E", "F": "the dispatch: host prep and F",
             "H": "the dispatch: host prep and H"}
    for key, (compile_ms, exec_ms) in out.items():
        print(f"26d profiler: {key}: compile {compile_ms:.3f} ms, execute {exec_ms:.4f} ms "
              f"(CUDA events read at settle, around {scope[key[0]]}"
              f"{'' if key[0] == 'A' else '; not a kernel time'})")
    print(f"26d: devicemon's ordinal 0 dispatches {mon['dispatches']} == kernel B's launches "
          f"{b_launches} == the scheduler's batches; monitoring_snapshot has its resilience "
          f"({mon_snap['resilience']}) and profiler ({len(mon_snap['profiler'])} names) sections")
    return {"profiler": out, "dispatches": mon["dispatches"]}


FALLBACK_COUNTERS = ("serving.hedge.fired", "serving.hedge.won_host", "serving.device_failover",
                     "serving.mesh.megabatch_failover", "serving.hedge.device_error",
                     "verifier.device_failover", "verifier.host_shed")


def fallbacks() -> dict:
    """The process registry's hedge, failover and shed counts."""
    from corda_tpu_torch.node.monitoring import node_metrics

    m = node_metrics().snapshot()
    return {k: m.get(k, {}).get("count", 0) for k in FALLBACK_COUNTERS}


def mesh_phase(dev, card, pool, oracle, want_plain) -> dict:
    """Phase 26: 26a-26d, each timed. The passes that inject no fault (26a,
    26c, 26d) must count no hedge, failover or shed."""
    t = [time.perf_counter()]
    f0 = fallbacks()
    out = {"26a": mesh_step_phase(dev, pool, oracle, want_plain)}
    clean = {k: v - f0[k] for k, v in fallbacks().items()}
    t.append(time.perf_counter())
    out["26b"] = resilience_phase(dev, pool, oracle)
    t.append(time.perf_counter())
    f0 = fallbacks()
    out["26c"] = mega_phase(dev, card, pool, oracle)
    t.append(time.perf_counter())
    out["26d"] = profiler_phase(dev, pool)
    t.append(time.perf_counter())
    clean = {k: v - f0[k] + clean[k] for k, v in fallbacks().items()}
    if any(clean.values()):
        raise AssertionError(f"26a, 26c or 26d hedged, failed over or shed: {clean}")
    print("26a, 26c, 26d (no fault injected): " + ", ".join(f"{k} {v}" for k, v in clean.items()))
    c = out["26c"]
    print(f"mesh step (torch ops over A, B a ordinal): {c['b']} lanes on {MESH_LOGICAL} logical "
          f"ordinals of one card {c['step_ms']:.3f} ms a step, host prep included (CUDA "
          f"events); the gather onto each ordinal {c['gather_ms']:.4f} ms, bound "
          f"{c['bound_ms']:.6f} ms by bytes ({c['gather_bytes']} bytes over 3.35 TB/s), "
          f"launches {out['26a']['launches']}  [{card}]")
    print("phase 26: " + ", ".join(f"{k} {b - a:.1f} s" for k, a, b in
                                   zip(("26a", "26b", "26c", "26d"), t, t[1:]))
          + f", {t[-1] - t[0]:.1f} s in all")
    return out

NODE_PAYMENTS = 24           # 27: Cash issues and concurrent payments over RPC
# 27: the story run on the card and, in a process of its own, on the CPU, to
# compare: the CPU's plain ladder takes seconds a call on the card's host,
# so this twin is kept short
NODE_TWIN_PAYMENTS = 4
NODE_TEMPLATE = """
myLegalName = "{name}"
baseDirectory = "{base}"
p2pAddress = "localhost:{port}"
verifierType = DeviceBatched
verificationWindowMs = 2
rpcUsers = [
    {{ username = admin, password = admin-pw, permissions = ["ALL"] }},
    {{ username = issuer, password = issuer-pw,
       permissions = ["{issue_perm}", "InvokeRpc.flow_result", "InvokeRpc.vault_query_by"] }},
    {{ username = nobody, password = nobody-pw, permissions = [] }},
    {{ username = hashed, passwordHash = "{hashed}", permissions = ["ALL"] }}
]
{notary}
"""
NODE_NAMES = {"alice": "O=Alice, L=London, C=GB", "bob": "O=Bob, L=Rome, C=IT",
              "notary": "O=Notary, L=Zurich, C=CH"}


def node_story(dev, base: str, n: int | None = None) -> dict:
    """Phase 27a's story on ``dev``: three Nodes from one HOCON text through
    ``load_config`` (the notary validating over the device state store), n
    issues to Alice and n concurrent payments to Bob through RPC, the user
    without permission refused, a vault query and the profiler's snapshot
    over RPC. Returns the comparable outcome (each flow's result, the
    refusal, both vaults' totals: which coins a payment takes depends on
    the order concurrent flows lock them) and the profiler snapshot."""
    import hashlib
    import os

    from corda_tpu_torch.crypto import derive_keypair_from_entropy
    from corda_tpu_torch.finance import CashIssueFlow, CashPaymentFlow, CashState
    from corda_tpu_torch.flows.api import class_path
    from corda_tpu_torch.ledger import CordaX500Name
    from corda_tpu_torch.messaging import InMemoryMessagingNetwork
    from corda_tpu_torch.node import (
        Node,
        NodeConfiguration,
        PageSpecification,
        QueryCriteria,
        load_config,
    )
    from corda_tpu_torch.node.config import hash_rpc_password
    from corda_tpu_torch.node.network_map import NetworkMapCache
    from corda_tpu_torch.observability import configure_profiler
    from corda_tpu_torch.rpc import CordaRPCClient
    from corda_tpu_torch.rpc.client import RPCException
    from corda_tpu_torch.rpc.ops import start_flow_permission
    from corda_tpu_torch.serving import shutdown_scheduler
    from corda_tpu_torch.statestore import configure_statestore, statestore_enabled

    n = NODE_PAYMENTS if n is None else n
    hashed = hash_rpc_password("hash-pw", iterations=1000, _salt=bytes(16))
    was_on = statestore_enabled()
    configure_statestore(enabled=True)
    configure_profiler(enabled=True, reset=True)
    net = InMemoryMessagingNetwork()
    net.start_pumping()
    cache = NetworkMapCache()
    nodes = {}
    try:
        for i, (role, name) in enumerate(NODE_NAMES.items()):
            path = os.path.join(base, f"{role}.conf")
            with open(path, "w") as f:
                f.write(NODE_TEMPLATE.format(
                    name=name, base=os.path.join(base, role), port=10002 + i,
                    issue_perm=start_flow_permission(CashIssueFlow), hashed=hashed,
                    notary="notary { validating = true }" if role == "notary" else ""))
            cfg = load_config(path)
            assert isinstance(cfg, NodeConfiguration)
            kp = derive_keypair_from_entropy(4, hashlib.sha256(b"node " + role.encode()).digest())
            nodes[role] = Node(cfg, net.create_node(str(CordaX500Name.parse(name))),
                               network_map=cache, keypair=kp, device=dev).start()
        alice, bob, notary = nodes["alice"], nodes["bob"], nodes["notary"]
        client = CordaRPCClient(net.create_node("rpc-client"), str(alice.party.name))
        admin, issuer, nobody, hashed_user = (
            client.start(user, f"{user}-pw" if user != "hashed" else "hash-pw", timeout_s=300)
            for user in ("admin", "issuer", "nobody", "hashed"))
        out = {"uniqueness": type(notary._notary_uniqueness).__name__,
               "hashed_ping": hashed_user.proxy.ping()}
        try:
            nobody.proxy.start_flow_dynamic(class_path(CashIssueFlow), 1, "GBP", b"\x00",
                                            notary.party)
            out["refused"] = None
        except RPCException as e:
            out["refused"] = str(e)
        issues = [issuer.proxy.start_flow_dynamic(class_path(CashIssueFlow), 100, "GBP",
                                                  bytes([i % 256]), notary.party)
                  for i in range(n)]
        out["issues"] = [type(issuer.proxy.flow_result(f, 300)).__name__ for f in issues]
        pays = [admin.proxy.start_flow_dynamic(class_path(CashPaymentFlow), 60, "GBP", bob.party)
                for _ in range(n)]
        out["payments"] = []
        for f in pays:
            try:
                out["payments"].append(type(admin.proxy.flow_result(f, 300)).__name__)
            except RPCException as e:
                out["payments"].append(str(e))
        page = admin.proxy.vault_query_by(QueryCriteria(contract_state_types=("CashState",)),
                                          PageSpecification(1, 1000))
        out["alice_total"] = sum(s.state.data.amount.quantity for s in page.states)
        bob_cash = bob.services.vault_service.unconsumed_states(CashState)
        out["bob_total"] = sum(s.state.data.amount.quantity for s in bob_cash)
        snap = admin.proxy.profiler_snapshot()
        for conn in (admin, issuer, nobody, hashed_user):
            conn.close()
        return {"out": out, "profiler": snap}
    finally:
        for node in nodes.values():
            node.stop()
        net.stop_pumping()
        configure_profiler(enabled=False, reset=True)
        configure_statestore(enabled=was_on)
        shutdown_scheduler()


NODE_STORY_CPU = """
import json, os, sys
os.nice(19)
import torch
torch.set_num_threads(2)
import chip_smoke
out = chip_smoke.node_story("cpu", sys.argv[1], int(sys.argv[2]))["out"]
with open(os.path.join(sys.argv[1], "out.json"), "w") as f:
    json.dump(out, f)
"""


def start_cpu_twin():
    """Phase 27's twin on the CPU: the story at ``NODE_TWIN_PAYMENTS`` with
    ``device="cpu"`` in a process of its own at the lowest priority, started
    before phase 1's build so that it runs on the cores the card's phases
    leave idle (the plain ladder takes seconds a call on the card's host).
    Returns (the process, its directory); an exit hook stops it."""
    import atexit
    import os
    import tempfile

    base = tempfile.mkdtemp(prefix="chip-smoke-twin-")
    with open(os.path.join(base, "log.txt"), "wb") as log:
        proc = subprocess.Popen([sys.executable, "-c", NODE_STORY_CPU, base,
                                 str(NODE_TWIN_PAYMENTS)], stdout=log, stderr=subprocess.STDOUT,
                                env=oop_worker_env(), cwd=os.path.dirname(os.path.abspath(__file__)))

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    return proc, base


def collect_cpu_twin(twin) -> dict:
    """Wait for the CPU twin and return its outcome; its directory goes."""
    import os
    import shutil

    proc, base = twin
    try:
        rc = proc.wait(timeout=900)
        if rc != 0:
            with open(os.path.join(base, "log.txt"), errors="replace") as f:
                raise AssertionError(f"the CPU story: rc {rc}: {f.read()[-2000:]}")
        with open(os.path.join(base, "out.json")) as f:
            return json.load(f)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(base, ignore_errors=True)


def start_node_process(base: str):
    """Phase 27a's process: ``python -m corda_tpu_torch.node.startup`` over a
    broker file, its node on the card (the entry point takes no device
    flag). Returns (the process, its log path, the broker path)."""
    import os

    from corda_tpu_torch.finance import CashIssueFlow
    from corda_tpu_torch.node.config import hash_rpc_password
    from corda_tpu_torch.rpc.ops import start_flow_permission

    node_dir = os.path.join(base, "proc")
    os.makedirs(node_dir, exist_ok=True)
    conf = os.path.join(node_dir, "node.conf")
    with open(conf, "w") as f:
        f.write(NODE_TEMPLATE.format(name="O=Proc, L=Oslo, C=NO", base=node_dir, port=10030,
                                     issue_perm=start_flow_permission(CashIssueFlow),
                                     hashed=hash_rpc_password("hash-pw", iterations=1000),
                                     notary="notary { validating = true }\n"
                                            'cordappPackages = ["corda_tpu_torch.finance"]'))
    broker_path = os.path.join(base, "broker.db")
    log_path = os.path.join(node_dir, "node.log")
    with open(log_path, "wb") as log:
        proc = subprocess.Popen([sys.executable, "-m", "corda_tpu_torch.node.startup",
                                 "--config", conf, "--broker", broker_path, "--no-banner",
                                 "--network-map"], stdout=log, stderr=subprocess.STDOUT,
                                env=oop_worker_env(), cwd=node_dir)
    return proc, log_path, broker_path


def drive_node_process(card, proc, log_path: str, broker_path: str, t0: float) -> dict:
    """One Cash issue over RPC into the node process from this process, its
    vault read back over RPC, then SIGTERM: rc 0."""
    import signal

    from corda_tpu_torch.finance import CashIssueFlow
    from corda_tpu_torch.flows.api import class_path
    from corda_tpu_torch.messaging import BrokerMessagingClient, DurableQueueBroker
    from corda_tpu_torch.rpc import CordaRPCClient

    def log() -> str:
        with open(log_path, errors="replace") as f:
            return f.read()

    broker = endpoint = None
    result = total = rc = None
    try:
        deadline = time.monotonic() + 120
        while "started" not in log():
            if proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError("the node process did not start: " + log()[-2000:])
            time.sleep(0.2)
        started_s = time.perf_counter() - t0
        broker = DurableQueueBroker(broker_path)
        endpoint = BrokerMessagingClient(broker, "chip-rpc-client")
        conn = CordaRPCClient(endpoint, "O=Proc, L=Oslo, C=NO").start("admin", "admin-pw",
                                                                      timeout_s=60)
        me = conn.proxy.node_info().legal_identity
        fid = conn.proxy.start_flow_dynamic(class_path(CashIssueFlow), 42, "GBP", b"\x2a", me)
        result = type(conn.proxy.flow_result(fid, 120)).__name__
        total = conn.proxy.vault_query_by().total_states_available
        conn.close()
    finally:
        if endpoint is not None:
            endpoint.stop()
        if broker is not None:
            broker.close()
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
    if (result, total) != ("SignedTransaction", 1) or rc != 0:
        raise AssertionError(f"the node process: {result}, {total} states, rc {rc}: "
                             + log()[-2000:])
    print(f"27a node process: python -m corda_tpu_torch.node.startup over a broker file on the "
          f"card, started {started_s:.1f} s after its launch; a Cash issue over RPC settled "
          f"({result}, {total} state); SIGTERM, rc {rc}  [{card}]")
    return {"started_s": started_s}


def host_cpu() -> str:
    """The host CPU's model name (``lscpu``, else ``/proc/cpuinfo``), with
    the machine's architecture."""
    import platform

    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
        for line in out.splitlines():
            if line.startswith("Model name:"):
                return f"{line.split(':', 1)[1].strip()} ({platform.machine()})"
    except (OSError, subprocess.SubprocessError):
        pass
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return f"{line.split(':', 1)[1].strip()} ({platform.machine()})"
    except OSError:
        pass
    return platform.machine() or "unknown"


def host_anchor_phase(dev, card, pool, oracle) -> dict:
    """Phase 27b: the host C loop over phase 3's 1,024 triples, its verdicts
    against the oracle, its sigs/s beside kernel B's at the same rows."""
    import torch

    from corda_tpu_torch.ops import host_ref
    from corda_tpu_torch.ops.ed25519_ladder import ed25519_verify_ladder, ladder_table
    from corda_tpu_torch.ops.scalar25519 import challenge_windows_plain

    pks, sigs, msgs = (list(c) for c in zip(*pool))
    host_ref.verify_loop(pks[:8], sigs[:8], msgs[:8])          # the build, untimed
    t0 = time.perf_counter()
    mask = host_ref.verify_loop(pks, sigs, msgs)
    host_s = time.perf_counter() - t0
    if mask.tolist() != [bool(v) for v in oracle]:
        bad = [i for i, (a, b) in enumerate(zip(mask.tolist(), oracle)) if a != bool(b)]
        raise AssertionError(f"host_ref != oracle at lanes {bad[:20]}")
    packed = torch.from_numpy(pack_triples(pool)).to(dev)
    win = challenge_windows_plain(packed)
    table = ladder_table(dev)
    b_ms = cuda_ms(lambda: ed25519_verify_ladder(packed, win, table), 20)
    n = len(pool)
    host_rate, b_rate = n / host_s, n / (b_ms / 1e3)
    print(f"27b host anchor: host_ref.verify_loop (portable C, -O2, one thread) {n} sigs in "
          f"{host_s * 1e3:.1f} ms = {host_rate:.0f} sigs/s, verdicts equal to the oracle  "
          f"[host CPU: {host_cpu()}]; kernel B (ed25519_verify_ladder) at the same {n} rows "
          f"{b_ms:.4f} ms = {b_rate:.0f} sigs/s ({b_rate / host_rate:.1f}x)  [{card}]")
    return {"host_sigs_s": host_rate, "b_sigs_s": b_rate}


def node_phase(dev, card, pool, oracle, cpu_twin=None) -> dict:
    """Phase 27: the node story on the card at ``NODE_PAYMENTS`` (launch
    counters zeroed just before, read just after; the profiler's roofline
    fields over RPC); its twin at ``NODE_TWIN_PAYMENTS`` on the card, equal
    to ``cpu_twin``'s on the CPU (``start_cpu_twin``; started here when not
    given); the node process (launched first, so it boots while the stories
    run); the host anchor."""
    import os
    import tempfile

    t = [time.perf_counter()]
    kernels = phase_kernels()
    cpu_twin = cpu_twin or start_cpu_twin()
    with tempfile.TemporaryDirectory() as base:
        for sub in ("card", "twin"):
            os.makedirs(os.path.join(base, sub))
        node_proc = start_node_process(base)
        try:
            for k in kernels:
                k.launches = 0
            card_run = node_story(dev, os.path.join(base, "card"))
            launches = {k.__name__: k.launches for k in kernels}
            t.append(time.perf_counter())
            twin = node_story(dev, os.path.join(base, "twin"), NODE_TWIN_PAYMENTS)["out"]
            t.append(time.perf_counter())
            proc = drive_node_process(card, *node_proc, t[0])
            t.append(time.perf_counter())
            anchor = host_anchor_phase(dev, card, pool, oracle)
            t.append(time.perf_counter())
            cpu_out = collect_cpu_twin(cpu_twin)
        finally:
            if node_proc[0].poll() is None:
                node_proc[0].kill()
                node_proc[0].wait()
        t.append(time.perf_counter())
    twin = json.loads(json.dumps(twin))
    if twin != cpu_out:
        raise AssertionError(f"the node on the card != on the CPU: {twin} != {cpu_out}")
    out = card_run["out"]
    for o, n in ((out, NODE_PAYMENTS), (twin, NODE_TWIN_PAYMENTS)):
        if o["refused"] is None or "may not start" not in o["refused"] or \
                o["hashed_ping"] != "pong":
            raise AssertionError(f"the user without permission was not refused, or the "
                                 f"hashed user not let in: {o}")
        if o["uniqueness"] != "DeviceShardedUniquenessProvider":
            raise AssertionError(f"the notary's uniqueness is {o['uniqueness']}")
        if o["issues"] != ["SignedTransaction"] * n or o["payments"] != o["issues"] or \
                (o["alice_total"], o["bob_total"]) != (40 * n, 60 * n):
            raise AssertionError(f"the node's issues and payments: {o}")
    if min(launches[k] for k in ("ed25519_challenge", "statestore_commit")) == 0 or not (
            launches["ed25519_verify_ladder"] or launches["ed25519_verify_g8"]):
        raise AssertionError(f"phase 27's launches: {launches}")
    kern = card_run["profiler"]["kernels"]
    roof = {k: kern.get(k, {}).get("roofline_rows_per_sec") for k in ("ed25519.verify", "sha512")}
    if not all(roof.values()):
        raise AssertionError(f"profiler_snapshot() over RPC has no roofline: {kern}")
    print(f"27a node: {NODE_PAYMENTS} issues and {NODE_PAYMENTS} concurrent payments through "
          f"RPC on three Nodes from one HOCON text (DeviceBatched, the notary validating over "
          f"{out['uniqueness']}): every flow settled, Alice's vault over RPC "
          f"{out['alice_total']} GBP, Bob's {out['bob_total']}; the user without permission "
          f"refused, the hashed user let in; launches {launches}; {t[1] - t[0]:.1f} s  "
          f"[{card}]")
    print(f"27a the twin at {NODE_TWIN_PAYMENTS} payments: on the card ({t[2] - t[1]:.1f} s) "
          f"equal to the CPU's run (a process of its own, at the lowest priority): {twin}")
    print("27a profiler_snapshot() over RPC: " + "; ".join(
        f"{k} {kern[k]['rows_per_sec']:.0f} rows/s (dispatch wall, host prep included) of its "
        f"data-sheet bound {roof[k]:.0f} ({kern[k]['roofline_frac']:.2%})" for k in roof)
        + f"  [{card}]")
    print(f"phase 27: card story {t[1] - t[0]:.1f} s, its twin {t[2] - t[1]:.1f} s, node "
          f"process {t[3] - t[2]:.1f} s, host anchor {t[4] - t[3]:.1f} s, waiting for the CPU "
          f"story {t[5] - t[4]:.1f} s, {t[-1] - t[0]:.1f} s in all")
    return {"launches": launches, "roofline": roof, **proc, **anchor}


def ladder_probe(tree: str) -> int:
    """Phases 11 and 9 alone, run by the chip_smoke.py of ``tree`` over that
    tree's package: the ed25519 ladders on phase 3's 1,024 lanes (every
    adversarial kind), then kernel F on both curves."""
    import os

    sys.path.insert(0, os.path.abspath(tree))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as tree_smoke

    from corda_tpu_torch.ops import _build

    card = smi("name,power.limit")
    print(f"{card}  [ladders of {os.path.abspath(tree)}]")
    _build.kernels()
    _kinds, pool, oracle = adversarial_pool()
    dev, int_rate = torch.device("cuda", 0), card_rates()[2]
    tree_smoke.check_g_kernel(dev, card, int_rate, pool, oracle)
    for curve in ("secp256k1", "secp256r1"):
        tree_smoke.check_ecdsa_kernel(dev, curve, card, int_rate)
    return 0


def notary_kernel_probe(tree: str) -> int:
    """Kernel E at a notary window's 2,048 lanes and kernel D over one
    window's Merkle levels, on the package and kernels of ``tree``, timed
    by this script's ``device_times``: D is the tree's one sweep launch
    where it has one (``sha256_merkle_sweep``), else its launch a level
    (``sha256_pair_level``) over the same plan."""
    import os

    sys.path.insert(0, os.path.abspath(tree))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from corda_tpu_torch.ops import _build

    card = smi("name,power.limit")
    print(f"{card}  [notary kernels of {os.path.abspath(tree)}]")
    _build.kernels()
    notary_kernel_times(torch.device("cuda", 0), card)
    return 0


def notary_kernel_times(dev, card, window=NOTARY_WINDOW) -> None:
    """``--notary-kernels``' checks and times on ``dev``, with whichever
    corda_tpu_torch is imported."""
    import numpy as np
    import torch

    from corda_tpu_torch.crypto import ed25519_host
    from corda_tpu_torch.ops import sha256 as sha
    from corda_tpu_torch.ops import txid
    from corda_tpu_torch.ops.ed25519_sign import comb_plain, comb_table, ed25519_comb
    from corda_tpu_torch.testing import notary_stream

    stream = notary_stream(2 * window, window, seed=20261017, device=dev)
    wtxs = [stx.tx for stx in stream.windows[1]]
    leaf_msgs, levels, roots, rows = txid._plan(*txid._flatten(wtxs))
    pool = torch.zeros((rows, 8), dtype=torch.int32, device=dev)
    sha.sha256_leaves(*sha.upload_messages(leaf_msgs, dev), out=pool[: len(leaf_msgs)])
    plan = [(first, torch.tensor(left, dtype=torch.int32, device=dev),
             torch.tensor(right, dtype=torch.int32, device=dev)) for first, left, right in levels]
    if hasattr(sha, "sha256_merkle_sweep"):
        def sweep():
            sha.sha256_merkle_sweep(pool, plan)
        shape = "one launch"
    else:
        def sweep():
            for first, left, right in plan:
                sha.sha256_pair_level(pool, left, right, first)
        shape = f"{len(plan)} launches"
    sweep()
    if sha.digest_words_to_bytes(pool[roots].cpu().numpy()) != [w.id.bytes for w in wtxs]:
        raise AssertionError("the window's roots != the host's ids")
    ms_d, host_d = device_times(sweep, 50)
    rng = random.Random(20261017)
    r_win = torch.from_numpy(np.frombuffer(b"".join(
        rng.randrange(ed25519_host.L).to_bytes(32, "little") for _ in range(window)),
        np.uint8).reshape(window, 32).copy()).to(dev)
    table = comb_table(dev)
    if not torch.equal(ed25519_comb(r_win, table), comb_plain(r_win, table)):
        raise AssertionError("kernel E != plain")
    ms_e, host_e = device_times(lambda: ed25519_comb(r_win, table), 20)
    print(f"ed25519_comb: {ms_e:.4f} ms on the card at {window} lanes, host "
          f"{host_e:.4f} ms a call  [{card}]")
    print(f"merkle levels of one window ({len(plan)} levels, "
          f"{sum(int(lv[1].shape[0]) for lv in plan)} pairs) as {shape}: {ms_d:.4f} ms on the "
          f"card, host {host_d:.4f} ms a call  [{card}]")


def challenge_times(dev, rng, card, int_rate, mhz, sizes=A_SIZES) -> dict:
    """Kernel A's time on the card and the host's time a call at each of
    ``sizes`` lanes, beside its bound and its serial floor (one warp's
    rounds chain); returns {lanes: ms}."""
    from corda_tpu_torch.ops.opcount import (
        CHALLENGE_INT_OPS_PER_LANE,
        CHALLENGE_ROUNDS_WARP_OPS,
    )
    from corda_tpu_torch.ops.scalar25519 import ed25519_challenge

    floor = serial_floor_ms(CHALLENGE_ROUNDS_WARP_OPS, mhz)
    one_thread = serial_floor_ms(CHALLENGE_INT_OPS_PER_LANE, mhz)
    out = {}
    for n in sizes:
        packed, _err = hold_challenge(dev, rng, n)
        ms, host_ms = device_times(lambda: ed25519_challenge(packed), 50)
        b_ms, b_by = bound(n * (128 + 64 * 4), n * CHALLENGE_INT_OPS_PER_LANE, int_rate)
        print(f"ed25519_challenge at B={n}: {ms:.4f} ms on the card, host {host_ms:.4f} ms a "
              f"call; bound {b_ms:.4f} ms by {b_by}, {b_ms / ms:.1%} of it; serial floor "
              f"{floor:.4f} ms ({CHALLENGE_ROUNDS_WARP_OPS} operations on the rounds warp at "
              f"{mhz:g} MHz; one thread a lane: {one_thread:.4f}), {floor / ms:.1%} of it"
              f"  [{card}]")
        out[n] = ms
    return out


def hash_kernel_probe(tree: str) -> int:
    """Kernels A and C on the package and kernels of ``tree``, each called
    as that tree's own paths call it, timed by this script's
    ``device_times``: C at a notary window's leaves, at 2,048 leaves of 13
    blocks and at one warp of leaves of 13, 1 and 7 blocks; A at B = 1,
    32, 512 and 8,192."""
    import os

    sys.path.insert(0, os.path.abspath(tree))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from corda_tpu_torch.ops import _build

    card = smi("name,power.limit")
    print(f"{card}  [hash kernels of {os.path.abspath(tree)}]")
    _build.kernels()
    print_ptxas("kernels A, C", ("ed25519_challenge", "sha256_leaves"))
    hash_kernel_times(torch.device("cuda", 0), card)
    return 0


def hash_kernel_times(dev, card, window=NOTARY_WINDOW) -> None:
    """``--hash-kernels``' checks and times on ``dev``, with whichever
    corda_tpu_torch is imported."""
    import torch

    from corda_tpu_torch.ops import scalar25519 as sc
    from corda_tpu_torch.ops import sha256 as sha
    from corda_tpu_torch.ops import txid
    from corda_tpu_torch.testing import notary_stream

    stream = notary_stream(2 * window, window, seed=20261017, device=dev)
    leaf_msgs = txid._plan(*txid._flatten([stx.tx for stx in stream.windows[1]]))[0]
    rng = random.Random(20261017)
    # one warp of 1, 7 and 13 blocks a leaf: the time a block of the serial
    # chain and the launch's fixed part
    shapes = [(f"the window's {len(leaf_msgs)} leaves", leaf_msgs)] + [
        (f"{lanes} leaves of 13 blocks", [rng.randbytes(C_LONG_BYTES) for _ in range(lanes)])
        for lanes in C_LONG_LANES] + [
        (f"32 leaves of {k} block{'s' * (k > 1)}", [rng.randbytes(nbytes) for _ in range(32)])
        for k, nbytes in ((1, 40), (7, 400))]
    for label, msgs in shapes:
        up = sha.upload_messages(msgs, dev)
        got = sha.sha256_leaves(*up)
        if sha.digest_words_to_bytes(got.cpu().numpy()) != [hashlib.sha256(m).digest()
                                                            for m in msgs]:
            raise AssertionError(f"kernel C != hashlib at {label}")
        ms, host_ms = device_times(lambda: sha.sha256_leaves(*up), 50)
        print(f"sha256_leaves at {label}: {ms:.4f} ms on the card, host {host_ms:.4f} ms a "
              f"call  [{card}]")
    for n in A_SIZES:
        plane, _msgs = fixed_plane(rng, n, 44)
        packed = torch.from_numpy(plane).to(dev)
        if not torch.equal(sc.ed25519_challenge(packed), sc.challenge_windows_plain(packed)):
            raise AssertionError(f"kernel A != plain at B={n}")
        ms, host_ms = device_times(lambda: sc.ed25519_challenge(packed), 50)
        print(f"ed25519_challenge at B={n}: {ms:.4f} ms on the card, host {host_ms:.4f} ms a "
              f"call  [{card}]")


def sphincs_kernel_probe(tree: str) -> int:
    """Kernel H on the package and kernels of ``tree``, held against the
    host engine and timed by this script's ``device_times`` at 8, 32, 64
    and 1,024 lanes of valid signatures, with TREE's ptxas report."""
    import os

    sys.path.insert(0, os.path.abspath(tree))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from corda_tpu_torch.ops import _build

    card = smi("name,power.limit")
    print(f"{card}  [kernel H of {os.path.abspath(tree)}]")
    _build.kernels()
    print_ptxas("kernel H", ("sphincs_verify",))
    print(f"kernel H: {_build.kernels().ct_sphincs_smem_bytes()} bytes of static shared memory "
          "a block")
    sphincs_kernel_times(torch.device("cuda", 0), card)
    return 0


def sphincs_kernel_times(dev, card, sizes=H_SIZES) -> None:
    """``--sphincs-kernel``'s checks and times on ``dev``, with whichever
    corda_tpu_torch is imported: every adversarial kind and four valid
    signatures against the host engine, then each size's valid lanes."""
    import numpy as np
    import torch

    from corda_tpu_torch.crypto import derive_keypair_from_entropy, sign, sphincs
    from corda_tpu_torch.ops.sphincs_batch import ROW_BYTES, pack_plane, split_plane, \
        sphincs_verify
    from corda_tpu_torch.testing import sphincs_adversarial_lanes

    valid = []
    for k in range(4):
        kp = derive_keypair_from_entropy(5, hashlib.sha256(b"phase 16 %d" % k).digest())
        msg = b"phase 16 message %d" % k
        valid.append((kp.public.encoded, sign(kp.private, msg), msg))

    def views_of(triples):
        plane = np.zeros(len(triples) * ROW_BYTES, np.uint8)
        pack_plane(plane, *map(list, zip(*triples)))
        return split_plane(torch.from_numpy(plane).to(dev))

    pool = [t[1:] for t in sphincs_adversarial_lanes(16)] + valid
    got = sphincs_verify(*views_of(pool)).cpu().tolist()
    if got != [sphincs.verify(*t) for t in pool]:
        raise AssertionError("kernel H != the host engine on the adversarial lanes")
    print(f"kernel H == sphincs.verify: {len(pool)} lanes ({sum(got)} accepted)")
    for n in sizes:
        views = views_of([valid[i % len(valid)] for i in range(n)])
        if not bool(sphincs_verify(*views).all()):
            raise AssertionError(f"kernel H refused a valid lane at B={n}")
        ms, host_ms = device_times(lambda: sphincs_verify(*views), 20 if n < 1024 else 5)
        print(f"sphincs_verify at B={n}: {ms:.4f} ms on the card, host {host_ms:.4f} ms a "
              f"call  [{card}]")


def stamped_sphincs_source(src: str) -> str:
    """A copy of kernel H's source (csrc/sphincs.cu of any tree) whose
    kernel takes a first argument ``ts`` and has thread 0 write clock64()
    into ts[16 * block + k] after the precheck and after every block-wide
    barrier: the SM clocks of each stage. Exported as ``stamped_launch``."""
    import re

    body = src[src.index("__global__"):src.index("extern \"C\"")]
    body = body.replace("sphincs_verify_kernel(",
                        "sphincs_stamped_kernel(unsigned long long* __restrict__ ts, ", 1)
    pre = re.search(r"if \(!pre\[\w+\]\) \{.*?return;\n    \}\n", body, re.S)
    body = (body[:pre.end()] + "    unsigned long long* tb = ts + (size_t)blockIdx.x * 16;\n"
            "    int tk = 0;\n    if (threadIdx.x == 0) tb[tk] = clock64();\n    tk++;\n"
            + body[pre.end():])
    body = body.replace("__syncthreads();",
                        "__syncthreads();\n        if (threadIdx.x == 0) tb[tk] = clock64();\n"
                        "        tk++;")
    return ("#include <cuda_runtime.h>\n#include \"sphincs.cuh\"\n" + body + """
extern "C" int stamped_launch(void* ts, const void* sigs, const void* dgs, const void* idxs,
                              const void* pre, void* out, int n) {
    sphincs_stamped_kernel<<<n, CT_SP_THREADS>>>((unsigned long long*)ts, (const uint8_t*)sigs,
        (const uint8_t*)dgs, (const int64_t*)idxs, (const uint8_t*)pre, (uint8_t*)out);
    return (int)cudaGetLastError();
}
""")


def statestore_kernel_probe(tree: str) -> int:
    """Kernels I, J and K on the package and kernels of ``tree``, timed by
    this script's timers: phase 24c's table built with the tree's own
    preload (its rows/s printed) and streamed batches, then I at 8,192 rows,
    J at 24c's batch and at a preload-sized batch, K at 8,192 rows
    (``scale_kernel_times`` without the holds)."""
    import os

    sys.path.insert(0, os.path.abspath(tree))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from corda_tpu_torch.ops import _build

    card = smi("name,power.limit")
    print(f"{card}  [statestore kernels of {os.path.abspath(tree)}]")
    _build.kernels()
    print_ptxas("kernels I, J, K", ("statestore",))
    _n_sm, _mhz, int_rate = card_rates()
    dev = torch.device("cuda", 0)
    prov, present, gen, rng = scale_load(dev, card, torch.cuda.synchronize)
    scale_kernel_times(dev, card, int_rate, torch.cuda.synchronize, prov._table, present, gen,
                       rng, hold=False)
    prov.close()
    return 0


def sphincs_stage_probe(tree: str) -> int:
    """Kernel H of ``tree`` with a clock64() stamp after every stage barrier
    (``stamped_sphincs_source``), built with nvcc beside TREE's kernels: the
    median SM clocks of each stage over the blocks at 32 and 1,024 lanes of
    valid signatures, and the kernel's time with this script's timer."""
    import ctypes
    import os

    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from corda_tpu_torch.crypto import derive_keypair_from_entropy, sign
    from corda_tpu_torch.ops import _build
    from corda_tpu_torch.ops.sphincs_batch import ROW_BYTES, pack_plane, split_plane

    card = smi("name,power.limit")
    print(f"{card}  [kernel H's stages of {os.path.abspath(tree)}]")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "sphincs_stamped.cu"
    src.write_text(stamped_sphincs_source((_build.CSRC / "sphincs.cu").read_text()))
    lib_path = _build.BUILD_DIR / "libsphincs_stamped.so"
    _build._run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC),
                 str(src), "-o", str(lib_path)])
    lib = ctypes.CDLL(str(lib_path))
    lib.stamped_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int]
    valid = []
    for k in range(4):
        kp = derive_keypair_from_entropy(5, hashlib.sha256(b"phase 16 %d" % k).digest())
        msg = b"phase 16 message %d" % k
        valid.append((kp.public.encoded, sign(kp.private, msg), msg))
    for n in (32, 1024):
        plane = np.zeros(n * ROW_BYTES, np.uint8)
        pack_plane(plane, *map(list, zip(*[valid[i % 4] for i in range(n)])))
        sigs, dgs, idxs, pre = split_plane(torch.from_numpy(plane).cuda())
        out = torch.zeros(n, dtype=torch.uint8, device="cuda")
        ts = torch.zeros(n * 16, dtype=torch.int64, device="cuda")

        def launch():
            rc = lib.stamped_launch(ts.data_ptr(), sigs.data_ptr(), dgs.data_ptr(),
                                    idxs.data_ptr(), pre.data_ptr(), out.data_ptr(), n)
            if rc:
                raise RuntimeError(f"stamped kernel H launch failed: cudaError {rc}")

        launch()
        torch.cuda.synchronize()
        if not bool(out.bool().all()):
            raise AssertionError(f"the stamped kernel H refused a valid lane at B={n}")
        t = ts.view(n, 16)[:, :11].cpu().numpy().astype(np.int64)
        stages = np.median(np.diff(t, axis=1), axis=0).astype(int).tolist()
        ms = device_times(launch, 20 if n < 1024 else 5)[0]
        print(f"kernel H stages at B={n}: SM clocks (median over blocks) {stages}, in all "
              f"{int(np.median(t[:, 10] - t[:, 0]))}; {ms:.4f} ms a launch with the stamps  "
              f"[{card}]")
    return 0


def main() -> int:
    import torch

    if len(sys.argv) == 3 and sys.argv[1] == "--ladders":
        return ladder_probe(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--notary-kernels":
        return notary_kernel_probe(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--hash-kernels":
        return hash_kernel_probe(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--sphincs-kernel":
        return sphincs_kernel_probe(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--sphincs-stages":
        return sphincs_stage_probe(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--statestore-kernels":
        return statestore_kernel_probe(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from corda_tpu_torch.batchverify import verify_rows
        from corda_tpu_torch.crypto import PublicKey, ed25519_host
        from corda_tpu_torch.ops import _build
        from corda_tpu_torch.ops.ed25519_ladder import (
            TABLE_ROWS,
            ed25519_verify_ladder,
            ladder_table,
            verify_ladder_plain,
        )
        from corda_tpu_torch.ops.opcount import CHALLENGE_INT_OPS_PER_LANE, ladder_int_ops
        from corda_tpu_torch.ops.scalar25519 import (
            challenge_windows_plain,
            ed25519_challenge,
        )
        from corda_tpu_torch.serving import BULK, INTERACTIVE, SERVICE
        from corda_tpu_torch.testing import signed_triples
        from corda_tpu_torch.verifier import dispatch_signature_rows
    except ImportError as e:
        print(f"chip_smoke: the corda_tpu_torch package is missing: {e}", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    rng = random.Random(20261016)
    if sys.argv[1:] == ["--service"]:
        card = smi("name,power.limit")
        print(card)
        _build.kernels()
        service_phase(dev, card)
        return 0
    if sys.argv[1:] == ["--resolve-flow"]:
        card = smi("name,power.limit")
        print(card)
        _build.kernels()
        resolve_flow_phase(dev, card)
        return 0
    if sys.argv[1:] == ["--notary-storm"]:
        card = smi("name,power.limit")
        print(card)
        _build.kernels()
        notary_storm_phase(dev, card)
        return 0
    if sys.argv[1:] == ["--durable"]:
        card = smi("name,power.limit")
        print(card)
        _build.kernels()
        from corda_tpu_torch.testing import notary_stream

        t0 = time.perf_counter()
        trader_phase(dev, card)
        oop_verifier_phase(dev, card)
        durable_notary_phase(dev, card, notary_stream(
            NOTARY_TXS, NOTARY_WINDOW, seed=20261017, contract_invalid=True, device=dev))
        exit_probe(card)
        print(f"phases 21-23: {time.perf_counter() - t0:.1f} s")
        return 0
    if sys.argv[1:] == ["--statestore"]:
        card = smi("name,power.limit")
        print(card)
        _n_sm, _mhz, int_rate = card_rates()
        _build.kernels()
        from corda_tpu_torch.testing import notary_stream

        statestore_phase(dev, card, int_rate, notary_stream(
            NOTARY_TXS, NOTARY_WINDOW, seed=20261017, contract_invalid=True, device=dev))
        return 0
    if sys.argv[1:] == ["--layers"]:
        card = smi("name,power.limit")
        print(card)
        _build.kernels()
        from corda_tpu_torch.testing import notary_stream

        t0 = time.perf_counter()
        stream = notary_stream(NOTARY_TXS, NOTARY_WINDOW, seed=20261017, contract_invalid=True,
                               device=dev)
        print(f"phase 8's stream built in {time.perf_counter() - t0:.1f} s")
        layers_phase(dev, card, stream)
        return 0
    if sys.argv[1:] == ["--mesh"]:
        card = smi("name,power.limit")
        print(card)
        _build.kernels()
        _kinds, pool, oracle = adversarial_pool()
        packed = torch.from_numpy(pack_triples(pool)).to(dev)
        want = verify_ladder_plain(packed, challenge_windows_plain(packed), ladder_table(dev))
        mesh_phase(dev, card, pool, oracle, want.cpu().numpy())
        return 0
    if sys.argv[1:] == ["--node"]:
        card = smi("name,power.limit")
        print(card)
        cpu_twin = start_cpu_twin()
        _build.kernels()
        _kinds, pool, oracle = adversarial_pool()
        node_phase(dev, card, pool, oracle, cpu_twin)
        return 0
    if sys.argv[1:] == ["--notary-cluster"]:
        card = smi("name,power.limit")
        print(card)
        _build.kernels()
        t0 = time.perf_counter()
        cluster_phase(dev, card)
        print(f"phase 20: {time.perf_counter() - t0:.1f} s")
        return 0

    start = time.perf_counter()
    # ---- 1. the card, the versions, the build
    card = smi("name,power.limit")
    print(card)
    n_sm, sm_clock_mhz, int_rate = card_rates()
    cpu_twin = start_cpu_twin()   # phase 27's, on idle cores from here on
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  {n_sm} SMs, max SM clock {sm_clock_mhz:g} MHz")
    t0 = time.perf_counter()
    _build.kernels()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({'compiled' if _build.build_info['built'] else 'cached'})")
    for line in _build.build_info["ptxas"].splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("ptxas:", line.strip())
    print_ptxas("kernels A, C", ("ed25519_challenge", "sha256_leaves"))
    print(f"kernel A: {_build.kernels().ct_ed25519_challenge_smem_bytes()} bytes of dynamic "
          "shared memory a 128-thread block (as the launch sets it)")

    print(f"phases 1-1: {time.perf_counter() - start:.1f} s")
    # ---- 2. kernel A against its plain version
    err_a = 0
    for n, mlen in [(n, 44) for n in A_SIZES] + [(37, 47), (256, 0), (256, 47)]:
        err_a = max(err_a, hold_challenge(dev, rng, n, mlen)[1])
        print(f"kernel A == plain == hashlib: {n} lanes, {mlen}-byte messages")

    print(f"phases 1-2: {time.perf_counter() - start:.1f} s")
    # ---- 3. kernel B against its plain version (and the oracle)
    t0 = time.perf_counter()
    kinds, pool, oracle = adversarial_pool()
    print(f"signed and oracle-checked {len(pool)} triples in "
          f"{time.perf_counter() - t0:.1f} s ({len(kinds)} adversarial kinds: "
          f"{', '.join(kinds)})")
    packed = torch.from_numpy(pack_triples(pool)).to(dev)
    win = challenge_windows_plain(packed)
    table = ladder_table(dev)
    got = ed25519_verify_ladder(packed, win, table)
    want = verify_ladder_plain(packed, win, table)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = torch.nonzero(got != want).flatten().tolist()
        raise AssertionError(f"kernel B != plain at lanes {bad[:20]}")
    if got.cpu().numpy().tolist() != oracle.tolist():
        raise AssertionError("kernel B != the pure-Python oracle")
    err_b = int((got.int() - want.int()).abs().max())
    print(f"kernel B == plain == oracle: {len(pool)} lanes, "
          f"{int(got.sum())} accepted")

    print(f"phases 1-3: {time.perf_counter() - start:.1f} s")
    # ---- 4. the main path through the scheduler
    var_pool = signed_triples(128, seed=8, msg_len=(1, 200))
    var_oracle = [ed25519_host.verify(*t) for t in var_pool]
    # the cofactored rule's verdicts, which full buckets take
    cof_oracle = verify_rows(pool)
    var_cof = verify_rows(var_pool)
    print(f"cofactored oracle: {sum(a != b for a, b in zip(oracle, cof_oracle))} of "
          f"{len(pool)} lanes differ from the cofactorless one")
    requests = []
    offset = 0
    for k, size in enumerate(MAIN_PATH_SIZES):
        idx = [(offset + i) % len(pool) for i in range(size)]
        requests.append(([pool[i] for i in idx], [bool(oracle[i]) for i in idx],
                         (BULK, SERVICE, INTERACTIVE)[k % 3], [cof_oracle[i] for i in idx]))
        offset += size
    idx = [i % len(var_pool) for i in range(VAR_REQUEST_ROWS)]
    requests.insert(3, ([var_pool[i] for i in idx], [var_oracle[i] for i in idx], SERVICE,
                        [var_cof[i] for i in idx]))
    n_rows = sum(len(r[0]) for r in requests)
    assert len(requests) >= 24 and n_rows >= 65536

    rows_by_req = [[(PublicKey(4, pk), s, m) for pk, s, m in req[0]] for req in requests]
    classes = [req[2] for req in requests]
    (launches, counters, batches, e2e_ms, wall_ms, steady_ms, prof,
     prof_wall_ms, took, a_batches) = backlog_passes(dev, rows_by_req, requests, classes,
                                                     n_rows,
                                                     (ed25519_challenge, ed25519_verify_ladder))
    launches_a = launches["ed25519_challenge"]
    launches_b = launches["ed25519_verify_ladder"]
    if launches_a == 0 or launches_b == 0:
        raise AssertionError(f"kernel launches A={launches_a} B={launches_b}: "
                             "the main path missed a kernel")
    if len(a_batches[0]) != launches_a:
        raise AssertionError(f"{len(a_batches[0])} batches of the first pass launch kernel A "
                             f"by their rows, but it was launched {launches_a} times")
    a_buckets = {b for sizes in a_batches for b in sizes}
    print(f"main path: {len(requests)} requests, {n_rows} signatures, "
          f"{len(batches)} device batches, every verdict == oracle where the two rules "
          f"agree (of the rows where they differ, {took[0]} took the cofactored verdict of a "
          f"full bucket, {took[1]} the cofactorless one), device_rows == {n_rows}; launches "
          f"A={launches_a} B={launches_b}; counters {counters}")
    print(f"e2e, first pass: {n_rows} sigs in {e2e_ms:.1f} ms (CUDA events; host "
          f"clock {wall_ms:.1f} ms) = {n_rows / e2e_ms * 1e3:.0f} sigs/s  [{card}]")
    print(f"e2e, steady pass: {n_rows} sigs in {steady_ms:.1f} ms (CUDA events) = "
          f"{n_rows / steady_ms * 1e3:.0f} sigs/s  [{card}]")
    busy_ms, device_us = device_busy(prof)
    print(f"profiled pass: {prof_wall_ms:.1f} ms host clock, device busy "
          f"{busy_ms:.1f} ms = {busy_ms / prof_wall_ms:.1%}; by name: "
          + ", ".join(f"{k.split('(')[0]} {v / 1e3:.2f} ms"
                      for k, v in sorted(device_us.items(), key=lambda kv: -kv[1]))
          + f"  [{card}]")

    # kernel A at every batch size the path gave it in the three passes
    for n in sorted(a_buckets):
        err_a = max(err_a, hold_challenge(dev, rng, n)[1])
    print(f"kernel A == plain == hashlib at every batch size the main path launched it at: "
          f"{sorted(a_buckets)}")

    print(f"phases 1-4: {time.perf_counter() - start:.1f} s")
    # ---- 5. kernel times at the path's full bucket, and their bounds
    n = 8192
    big = torch.from_numpy(pack_triples([pool[i % len(pool)] for i in range(n)])).to(dev)
    win_big = ed25519_challenge(big)
    # kernel B against its plain version at the main path's bucket too
    got_big = ed25519_verify_ladder(big, win_big, table)
    want_big = verify_ladder_plain(big, win_big, table)
    torch.cuda.synchronize()
    if not torch.equal(got_big, want_big):
        bad = torch.nonzero(got_big != want_big).flatten().tolist()
        raise AssertionError(f"kernel B != plain at {n} lanes, lanes {bad[:20]}")
    if got_big.cpu().numpy().tolist() != [bool(oracle[i % len(pool)]) for i in range(n)]:
        raise AssertionError(f"kernel B != the pure-Python oracle at {n} lanes")
    err_b = max(err_b, int((got_big.int() - want_big.int()).abs().max()))
    print(f"kernel B == plain == oracle: {n} lanes, {int(got_big.sum())} accepted")
    ms_a, host_a = device_times(lambda: ed25519_challenge(big), 50)
    plain_ms_a = plain_ms(lambda: challenge_windows_plain(big), 3)
    ms_b = cuda_ms(lambda: ed25519_verify_ladder(big, win_big, table), 10)
    plain_ms_b = plain_ms(lambda: verify_ladder_plain(big, win_big, table))
    bound_a = bound(n * (128 + 64 * 4), n * CHALLENGE_INT_OPS_PER_LANE, int_rate)
    bound_b = bound(n * (161 + 64 * 4 + 1) + TABLE_ROWS * 40, n * ladder_int_ops(8),
                    int_rate)
    for name, ms, p_ms, (b_ms, b_by) in (
        ("ed25519_challenge", ms_a, plain_ms_a, bound_a),
        ("ed25519_verify_ladder", ms_b, plain_ms_b, bound_b),
    ):
        print(f"{name}: {ms:.4f} ms on the card at B={n} (plain {p_ms:.1f} ms, bound "
              f"{b_ms:.4f} ms by {b_by}, {b_ms / ms:.1%} of it)  [{card}]")
    print(f"ed25519_challenge: host {host_a:.4f} ms a call at B={n}  [{card}]")
    challenge_times(dev, rng, card, int_rate, sm_clock_mhz)

    # the ladder's time per launch against its lanes
    sweep = []
    for lanes in (1024, n, 4 * n):
        reps = -(-lanes // n)
        packed_l = big.repeat(reps, 1)[:lanes].contiguous()
        win_l = win_big.repeat(1, reps)[:, :lanes].contiguous()
        sweep.append((lanes, cuda_ms(lambda: ed25519_verify_ladder(packed_l, win_l, table), 5)))
    print("ed25519_verify_ladder per launch: " + ", ".join(
        f"{lanes} lanes {ms:.3f} ms" for lanes, ms in sweep) + f"  [{card}]")

    # the host's share of one full bucket: prep and enqueue on the
    # dispatching thread (host clock), against the kernels' time
    rows_n = [(PublicKey(4, pk), s, m) for pk, s, m in (pool[i % len(pool)] for i in range(n))]
    prep_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = dispatch_signature_rows(rows_n, min_bucket=n, device=dev)
        prep_ms.append((time.perf_counter() - t0) * 1e3)
        pending.collect()
    print(f"one {n}-row bucket: host prep + enqueue {sorted(prep_ms)[2]:.2f} ms "
          f"(median of 5), kernels A + B {ms_a + ms_b:.2f} ms  [{card}]")
    # where the host's share goes: one more dispatch under cProfile (which
    # inflates Python-heavy calls; read it as a ranking, not as times)
    torch.cuda.synchronize()
    prof_host = cProfile.Profile()
    pending = prof_host.runcall(dispatch_signature_rows, rows_n, min_bucket=n, device=dev)
    pending.collect()
    top = sorted(pstats.Stats(prof_host).stats.items(), key=lambda kv: -kv[1][2])[:6]
    print("host prep under cProfile, by own time: " + ", ".join(
        f"{func[2]} ({func[0].rsplit('/', 1)[-1]}:{func[1]}) {tt * 1e3:.2f} ms"
        for func, (_cc, _nc, tt, _ct, _callers) in top))

    print(f"phases 1-5: {time.perf_counter() - start:.1f} s")
    # ---- 6. kernels C and D against their plain versions and hashlib
    err_c, err_d = check_sha256_kernels(dev, rng)

    print(f"phases 1-6: {time.perf_counter() - start:.1f} s")
    # ---- 7. kernel E against its plain version and the oracle
    err_e = check_comb_kernel(dev, rng)

    print(f"phases 1-7: {time.perf_counter() - start:.1f} s")
    # ---- 8. the notary path
    notary = notary_phase(dev, rng, card, int_rate)
    launches_n = notary["launches"]
    ms_c, plain_ms_c, bound_c, err_c_path = notary["sha256_leaves"]
    ms_d, plain_ms_d, bound_d, err_d_path = notary["sha256_merkle_sweep"]
    ms_e, plain_ms_e, bound_e, err_e_path = notary["ed25519_comb"]
    err_c, err_d, err_e = max(err_c, err_c_path), max(err_d, err_d_path), max(err_e, err_e_path)

    print(f"phases 1-8: {time.perf_counter() - start:.1f} s")
    # ---- 9. kernel F against its plain version and the oracle
    entry = ""
    for line in _build.build_info["ptxas"].splitlines():
        if "Compiling entry" in line:
            entry = line
        if "ecdsa_verify" in entry and any(w in line for w in ("Compiling entry", "registers",
                                                               "spill")):
            print("ptxas (kernel F):", line.strip())
    print(f"kernel F: {_build.kernels().ct_ecdsa_verify_smem_bytes()} bytes of dynamic shared "
          "memory a 128-thread block (as the launch sets it)")
    ecdsa = {curve: check_ecdsa_kernel(dev, curve, card, int_rate)
             for curve in ("secp256k1", "secp256r1")}

    print(f"phases 1-9: {time.perf_counter() - start:.1f} s")
    # ---- 10. the mixed-scheme path
    launches_m = mixed_phase(dev, card)

    print(f"phases 1-10: {time.perf_counter() - start:.1f} s")
    # ---- 11. kernels B and G, both shapes, against their plain versions and
    # the oracle, and their times in turns
    ladders = check_g_kernel(dev, card, int_rate, pool, oracle)

    print(f"phases 1-11: {time.perf_counter() - start:.1f} s")
    # ---- 12. the backlog on the radix-4096 tier
    launches_g8 = tier_backlog_phase(dev, card, rows_by_req, requests, classes, n_rows)

    print(f"phases 1-12: {time.perf_counter() - start:.1f} s")
    # ---- 13. the validating notary on each tier
    launches_v = validating_phase(dev, card, notary["stream"])
    from corda_tpu_torch.ops.ed25519 import Ed25519Tier

    launches_b4 = launches_v[Ed25519Tier(8192, 4)]["ed25519_verify_ladder_w4"]
    launches_g4 = launches_v[Ed25519Tier(4096, 4)]["ed25519_verify_g4"]

    print(f"phases 1-13: {time.perf_counter() - start:.1f} s")
    # ---- 14. full ed25519 buckets under the cofactored rule, each tier
    cofactored_phase(dev, card, pool)

    print(f"phases 1-14: {time.perf_counter() - start:.1f} s")
    # ---- 15. the back-chain resolve
    resolve_phase(dev, card)

    print(f"phases 1-15: {time.perf_counter() - start:.1f} s")
    # ---- 16. kernel H alone
    sph = check_sphincs_kernel(dev, card, int_rate, sm_clock_mhz)
    h_ms, h_plain_ms, h_bound, err_h = sph[H_MIXED_BUCKET]

    print(f"phases 1-16: {time.perf_counter() - start:.1f} s")
    # ---- 17. the verifier service
    service = service_phase(dev, card)

    print(f"phases 1-17: {time.perf_counter() - start:.1f} s")
    # ---- 18. the resolve flow between two nodes
    resolve_flow_phase(dev, card)

    print(f"phases 1-18: {time.perf_counter() - start:.1f} s")
    # ---- 19. notarisation: the notary storms
    notary_storm_phase(dev, card, stream=notary["stream"])

    print(f"phases 1-19: {time.perf_counter() - start:.1f} s")
    # ---- 20. the notary clusters
    cluster_phase(dev, card, stream=notary["stream"])

    print(f"phases 1-20: {time.perf_counter() - start:.1f} s")
    # ---- 21. the trader demo
    trader_phase(dev, card)

    print(f"phases 1-21: {time.perf_counter() - start:.1f} s")
    # ---- 22. the out-of-process verifier
    oop_verifier_phase(dev, card, service=service)

    print(f"phases 1-22: {time.perf_counter() - start:.1f} s")
    # ---- 23. the durable notary, and the exit probe
    durable_notary_phase(dev, card, notary["stream"])
    exit_probe(card)

    print(f"phases 1-23: {time.perf_counter() - start:.1f} s")
    # ---- 24. the device state store
    store = statestore_phase(dev, card, int_rate, notary["stream"])

    print(f"phases 1-24: {time.perf_counter() - start:.1f} s")
    # ---- 25. the host observability layers and the open-loop harness
    layers_phase(dev, card, notary["stream"])

    print(f"phases 1-25: {time.perf_counter() - start:.1f} s")
    # ---- 26. multi-device serving: the mesh, resilience, the mega-batch, the profiler
    check = mesh_phase(dev, card, pool, oracle, want.cpu().numpy())["26c"]["check"]

    print(f"phases 1-26: {time.perf_counter() - start:.1f} s")
    # ---- 27. the node and its RPC, the node process, the host anchor
    node_phase(dev, card, pool, oracle, cpu_twin)

    print(f"phases 1-27: {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": "ed25519_challenge", "route": "cuda",
         "source": "corda_tpu_torch/csrc/ed25519_challenge.cu",
         "replaces": "corda_tpu/ops/ed25519.py:355",
         "launches": launches_a, "max_abs_err": float(err_a), "ms": ms_a,
         "plain_ms": plain_ms_a, "bound_ms": bound_a[0], "bound_by": bound_a[1],
         "library_ms": None},
        {"name": "ed25519_verify_ladder", "route": "cuda",
         "source": "corda_tpu_torch/csrc/ed25519_verify.cu",
         "replaces": "corda_tpu/ops/ed25519_pallas13.py:388",
         "launches": launches_b, "max_abs_err": float(err_b), "ms": ms_b,
         "plain_ms": plain_ms_b, "bound_ms": bound_b[0], "bound_by": bound_b[1],
         "library_ms": None},
        {"name": "sha256_leaves", "route": "cuda",
         "source": "corda_tpu_torch/csrc/sha256.cu",
         "replaces": "corda_tpu/ops/sha256.py:117",
         "launches": launches_n["sha256_leaves"], "max_abs_err": float(err_c),
         "ms": ms_c, "plain_ms": plain_ms_c, "bound_ms": bound_c[0],
         "bound_by": bound_c[1], "library_ms": None},
        {"name": "sha256_merkle_sweep", "route": "cuda",
         "source": "corda_tpu_torch/csrc/sha256.cu",
         "replaces": "corda_tpu/ops/sha256.py:142",
         "launches": launches_n["sha256_merkle_sweep"], "max_abs_err": float(err_d),
         "ms": ms_d, "plain_ms": plain_ms_d, "bound_ms": bound_d[0],
         "bound_by": bound_d[1], "library_ms": None},
        {"name": "ed25519_comb", "route": "cuda",
         "source": "corda_tpu_torch/csrc/ed25519_comb.cu",
         "replaces": "corda_tpu/ops/ed25519_sign.py:89",
         "launches": launches_n["ed25519_comb"], "max_abs_err": float(err_e),
         "ms": ms_e, "plain_ms": plain_ms_e, "bound_ms": bound_e[0],
         "bound_by": bound_e[1], "library_ms": None},
    ] + [
        {"name": name, "route": "cuda", "source": "corda_tpu_torch/csrc/ecdsa_verify.cu",
         "replaces": "corda_tpu/ops/secp256_pallas.py:1120",
         "launches": launches_m[name], "max_abs_err": float(ecdsa[curve][3]),
         "ms": ecdsa[curve][0], "plain_ms": ecdsa[curve][1], "bound_ms": ecdsa[curve][2][0],
         "bound_by": ecdsa[curve][2][1], "library_ms": None}
        for name, curve in (("ecdsa_verify_k1", "secp256k1"), ("ecdsa_verify_r1", "secp256r1"))
    ] + [
        {"name": name, "route": "cuda", "source": f"corda_tpu_torch/csrc/{source}",
         "replaces": replaces, "launches": n_launch,
         "max_abs_err": float(ladders[name][3]), "ms": ladders[name][0],
         "plain_ms": ladders[name][1], "bound_ms": ladders[name][2][0],
         "bound_by": ladders[name][2][1], "library_ms": None}
        for name, source, replaces, n_launch in (
            ("ed25519_verify_ladder_w4", "ed25519_verify.cu",
             "corda_tpu/ops/ed25519_pallas13.py:388", launches_b4),
            ("ed25519_verify_g8", "ed25519_verify_g.cu", "corda_tpu/ops/ed25519_pallas.py:523",
             launches_g8),
            ("ed25519_verify_g4", "ed25519_verify_g.cu", "corda_tpu/ops/ed25519_pallas.py:523",
             launches_g4))
    ] + [
        {"name": "sphincs_verify", "route": "cuda", "source": "corda_tpu_torch/csrc/sphincs.cu",
         "replaces": "corda_tpu/ops/sphincs_batch.py:279",
         "launches": launches_m["sphincs_verify"], "max_abs_err": float(err_h), "ms": h_ms,
         "plain_ms": h_plain_ms, "bound_ms": h_bound[0], "bound_by": h_bound[1],
         "library_ms": None},
    ] + [
        {"name": name, "route": "cuda", "source": "corda_tpu_torch/csrc/statestore.cu",
         "replaces": f"corda_tpu/statestore/table.py:{line}", "launches": store[name][0],
         "max_abs_err": float(store[name][4]), "ms": store[name][1],
         "plain_ms": store[name][2], "bound_ms": store[name][3][0],
         "bound_by": store[name][3][1], "library_ms": None}
        for name, line in (("statestore_probe", 190), ("statestore_commit", 225),
                           ("statestore_remove", 317))
    ] + [
        {"name": "statestore_commit_check", "route": "cuda",
         "source": "corda_tpu_torch/csrc/statestore.cu",
         "replaces": "corda_tpu/statestore/table.py:225", **check, "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
