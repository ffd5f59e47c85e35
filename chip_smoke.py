#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels against
their plain PyTorch versions.

Run from the root of a checkout on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from the checkout's sources (one
nvcc per source, all started together: K1, the forward, the backward, K3's
window kernel, K3's split-KV decode kernel with its combine, the wide-
head-dim instances and, for phase 36, the forward's tuned instances;
phases 2-4 need only K1 and run while the attention kernels build), then:

1. prints the build times, each kernel's ptxas lines (registers, shared
   memory, spills; a spill above ``SPILL_LIMITS`` fails, so any in the
   bf16 forward), its design line (CTA shape, tiles, ring stages, shared
   memory) and the card (``nvidia-smi`` name, power limit);
2. holds K1 (``hist_cuda``) against ``hist_torch`` at the main path's
   shapes: the root histogram, a masked one (~30 % of rows) and a
   ``count < n`` one whose rows past ``count`` are padding, and times the
   root and the masked scan beside ``index_add_`` alone and the bandwidth
   bound;
3. fits ``LightGBMClassifier`` (500,000 x 28, Higgs-shaped as in
   ``bench.py``'s GBDT workload; 31 leaves, 255 bins, 20 iterations) on the
   card through K1, transforms, and scores AUC with
   ``ComputeModelStatistics``, counting K1 launches in the fit and reading
   K1's device time over one fit from ``torch.profiler``;
4. fits again with the plain histogram on the card and holds the two fits
   together;
5. holds K2a (``flash_cuda``) against ``flash_torch`` at the text path's
   attention shape (B=32, H=8, T=2048, D=64, bf16, q/k/v as views of one
   fused projection, the key mask of the seeded documents plus one fully
   masked row, which must come out exactly 0), at a ragged T=2000 in f32,
   and at a ragged T=300 at head dims 16, 32, 64, 96, 128, 192, 256, 320
   and 512 in bf16 and f32 (16, 96, 192 and 320 zero-padded to the
   kernel's 32, 128, 256 and 384; above 256 in bf16 and 128 in f32 on the
   wide kernels, split over D as ``wide_plan`` says), and at T=200 at bf16
   1024 and 2048 and f32 1024 (clusters of 4-16 CTAs) and at bf16 2176
   and f32 1152 (the split kernels beyond a cluster), most keys valid;
   the wide K2a with one CTA's share of S left out of the cluster's sum
   (a planted fault, bf16 1024 and f32 512: clusters of 4) must fail that
   hold; times the wide kernels beside their plain versions,
   their bounds and SDPA (no limit); times the kernel,
   the plain version and ``scaled_dot_product_attention`` (the library
   yardstick only) beside the bound;
6. runs the text path at full width: 32 seeded documents of 1,024-2,048
   words → ``TokenIdEncoder(maxLength=2048, vocabSize=32768)`` →
   ``TextEncoderFeaturizer(attentionImpl="pallas")`` over a seeded
   ``TextEncoder(vocab=32768, width=512, depth=8, heads=8, mlp_dim=2048)``
   (``bench.py``'s long-context encoder shape), counting K2a launches per
   transform, then the same transform with ``attentionImpl="dense"``, and
   holds the two sets of pooled embeddings together; the same encoder run
   through K2a with the key mask dropped (a planted fault) must fail that
   comparison;
7. holds K2b (``flash_lse_cuda``), K2d (``flash_dq_cuda``) and K2e
   (``flash_dkv_cuda``) against their plain versions at the training path's
   attention shape (B=8, H=8, T=2048, D=64, bf16, q/k/v as views of one
   fused projection, the key mask of the first 8 documents plus one fully
   masked row, whose outputs and gradients must be exactly 0), with a
   nonzero lse cotangent, at a ragged T=2000 in f32, and at a ragged T=300
   at head dims 32, 64, 96 (padded), 128, 192 (padded), 256, 320 (padded)
   and 512 in bf16 and f32, and at phase 5's T=200 head dims (bf16 1024,
   2048 and 2176, f32 1024 and 1152); checks that two K2d/K2e launches on
   the same inputs are bit-equal, at the wide head dims too (bf16 2048:
   K2e in clusters of 16 CTAs); times the wide
   instances beside their plain versions, bounds and SDPA's forward and
   backward (no limit), and each kernel, its plain
   version and ``scaled_dot_product_attention``'s forward and backward (the
   library yardstick only) beside the bound;
8. runs masked-LM pretraining at full width: the documents →
   ``TokenIdEncoder(maxLength=2048, vocabSize=32767)`` →
   ``pretrain_masked_lm`` of a seeded ``MaskedLMModel`` over the same
   encoder shape with ``make_attention_fn("pallas")``, batch 8, the default
   AdamW: one warm-up step, then timed windows of ``--train-steps`` steps,
   counting K2b, K2d and K2e launches per step (8 each, one per block) and
   K2a's (0); holds one step's loss and every parameter's gradient through
   the kernels against autograd through dense attention, on the same
   weights and batch, and a planted fault (K2d/K2e with ``dsum`` zeroed)
   must fail those limits; then embeds the documents with the trained
   trunk through ``TextEncoderFeaturizer`` (K2a) and dense attention and
   holds the pooled embeddings together as phase 6 does, with limits set
   for the trained trunk and the same planted fault.

9. holds K2c (``flash_causal_cuda``) against the causal ``flash_torch`` at
   the causal shapes of ``bench.py`` (``[2, 8, 2048, 64]``,
   ``[1, 8, 8192, 64]``), the ``generate`` prefill ``[32, 8, 128, 64]``,
   phase 7's document mask with one fully masked row, offsets ``(2048, 0)``
   (every key reachable) and ``(0, 2048)`` (exactly 0), a ragged T=2000 in
   f32 and head dims 32/64/128/192/256/320/512 at T=300 (bf16 and f32)
   and phase 5's T=200 head dims at offsets (5, 23); holds K3 through ``paged_window_attention``'s choice (the split-KV
   decode kernel ``paged_decode_cuda`` up to 16 window rows, the window
   kernel ``paged_cuda`` above) against ``paged_torch`` at ``w`` = 1, 5 and
   128 over 32 slots of seeded context lengths (``BL`` 16, shuffled chains
   padded with the trash block, one all-trash slot that must be exactly 0),
   at ``w`` = 5 with ``BL`` 8 and 128, at a one-chunk table, and at ``w =
   4096`` over one 4096-token chain of ``BL`` 128, in both dtypes and at
   head dims 32, 128, 16 (pools padded to 32, as the engine allocates them),
   256, 192 (pools padded to 256), 320 (padded to 384), 512 and 1024
   (clusters of 4 CTAs in bf16, 8 in f32), and holds
   the window kernel, called directly, on every one of those cases too (so
   each of its instances meets a case); holds the window kernel on windows
   wider than 16 rows at the engine's prefill shapes (``w`` = 192 with one
   and four slots, ``w`` = 32, tables of 18 blocks of 16), a warm suffix
   over a 4096-position table (the plan splits the chain: partials and the
   combine), ``w`` = 17, block lengths 4 and 12 (4-row boxes) and 5 at
   head dim 32 (register copies), head dims 16, 32, 128, 192 and 256, both
   dtypes; asserts the
   decode shape's plan has more than one chunk and the short table's one,
   that two decode launches, and two window launches at the prefill
   window and the split ones, are bit-equal; times each beside its bound,
   its plain version and a PyTorch yardstick
   (``scaled_dot_product_attention``; for K3 over a dense cache gathered
   beforehand), the window kernel with its plan and CTAs at the engine's
   prefill shapes, the split one and the long prompt, the decode kernel
   beside the window kernel at the decode and verify windows, and the
   per-kernel device times from ``torch.profiler``; times the window
   kernel's wide route (pools at hd 512 in bf16 and 256 in f32, ``w`` =
   128 over 32 slots) beside its plain version, bound and SDPA on the
   gathered cache;
10. runs ``generate`` at full width: the causal LM of ``bench.py:896-930``
    (the encoder shape above with an f32 LM head, seeded weights, causal
    ``pallas`` attention) on 32 seeded prompts of 129 tokens with 128 new
    tokens, counting K2c launches (24 in the first call: the causality
    probe and the prefill; 8 in each later one), timing the prefill and the
    decode step against dense causal attention, reading the probe's drift
    (exactly 0), and re-scoring every generated token with the dense
    causal forward; K2c with its causal bound one tile late (a planted
    fault) must fail the re-score limit;
11. runs ``LLMEngine`` on the same model: cold and warm rounds over prompts
    sharing a 112-token prefix (TTFT from the registry, prefix hit rate),
    the 32 prompts of phase 10 at once (16 slots, ``block_len`` 16), self-
    draft speculation with ``spec_k=4``, and one 4064-token prompt with
    ``block_len`` 128, counting K3 launches per prefill batch and decode
    step (the window kernel per prefill batch, its combine never: no table
    here splits, the decode kernel per decode step and verify) and
    re-scoring every output; K3 with ``pos`` ignored
    in both kernels (a planted fault) must fail the re-score limit; prints
    K3's per-step time at 4096 positions for both kernels; then an engine
    at head dim 16
    sized by ``num_blocks=None``, whose pools (at K3's head dim 32, a
    self-draft's included) must hold exactly ``num_blocks`` x the block
    bytes, within half the free memory, and whose tokens are re-scored;
12. holds K2c-lse (``flash_lse_cuda(causal=True)``, K2c with the lse, which
    also stands for causal K2b), causal K2d and causal K2e
    (``flash_dq_cuda``/``flash_dkv_cuda(causal=True)``) against their plain
    versions at the training shape of phase 7 (``[8, 8, 2048, 64]`` bf16,
    q/k/v views of one projection, the documents' mask with one fully
    masked row, a nonzero lse cotangent) at offsets ``(0, 0)``,
    ``(2048, 0)``, ``(100, 37)`` and ``(0, 2048)`` (o, dq, dk, dv exactly 0
    and lse -1e30 wherever no pair is allowed), at a ragged T=2000 in f32
    and at head dims 32/64/128/192/256/320/512 at T=300 (bf16 and f32)
    and at phase 5's T=200 head dims at offsets (5, 23),
    checks the causal K2d/K2e bit-equal over two launches, at the wide head
    dims too; times the wide instances beside their plain versions, bounds
    and SDPA (no limit), and each beside
    its plain version, its bound over the causally allowed valid pairs and
    ``scaled_dot_product_attention`` (with the causal key mask, and
    ``is_causal`` without it: yardsticks only);
13. runs causal-LM pretraining at full width: the documents →
    ``TokenIdEncoder(maxLength=2049, vocabSize=32768)`` →
    ``pretrain_causal_lm`` of phase 10's seeded causal LM, batch 8 at
    T=2048, the default AdamW: one warm-up step, then timed calls of
    ``--train-steps`` steps, counting launches (K2c-lse, causal K2d and
    causal K2e 8 a step; the causality probe's 16 K2c a call; no
    non-causal launch); holds one step's loss and every gradient against
    dense causal attention (causal K2e with its bound one q tile late, a
    planted fault, must fail the limits) and a ``remat=True`` step against
    the plain one (K2c-lse 16 launches); then ``generate`` on the trained
    weights, 8 prompts of 129 document tokens with 32 new, re-scored
    against the dense causal forward, and the trained model's forward
    through K2c held against the dense one logit by logit at the
    generated positions (K2c one tile late must fail that);
14. runs SURVEY §7.3's chain from raw columns: phase 3's 500,000 rows as
    28 float32 columns (2 % NaN, seeded, in seven), a 12-level and a
    2,000-level string column, a bool and a datetime64[s] column, the
    label depending on the strings too → ``CleanMissingData`` (Median, on
    three of the NaN columns) → ``Featurize(numFeatures=32)`` (the
    2,000-level column hashed) → ``LightGBMClassifier`` (phase 3's
    settings) through ``Pipeline.fit``, then ``transform`` and
    ``ComputeModelStatistics``; prints both stages' fit and transform
    seconds and rows/s (warm, median of 3, each ending in a synchronize)
    and the host string encodings' share; holds the card's features bit
    for bit against a numpy assembly from the fitted plan (the one-hot one
    slot late, a planted fault, must differ), the fills within 1e-6
    relative of the same stages fitted with ``device="cpu"``, the same
    nonzero K1 launches in every chain fit and no plain-histogram call,
    and the chain's AUC within 1e-3 of a direct fit on the numpy-assembled
    vectors with the same root split;
15. fits ``Word2Vec`` (``vectorSize`` 100, window 5, 5 negatives, 3
    epochs) on the card over a seeded corpus of 25,000 sentences of 12
    words, each drawn from one of 200 groups of 10 words (300,000 tokens),
    prints seconds per epoch and pairs/s, and holds the epoch losses
    finite and falling, the nearest neighbour (``findSynonyms(w, 1)``) in
    the word's group for at least 90 % of words, and the card's
    ``transform`` within 1e-5 of the same model on the CPU;
16. fits ``LightGBMClassifier(objective="multiclass")`` through K1 on
    phase 3's features with 7 classes cut from the margin plus its noise
    draw at its 1/7 ... 6/7 quantiles (Covertype's class count), 20
    iterations (140 trees), with the training metric: a 2-iteration fit
    with the plain histogram first, whose 7 iteration-0 root splits and
    training ``multi_logloss`` (1e-3 relative) must equal the kernel fit's,
    then two timed fits with the same nonzero K1 launches and no
    plain-histogram call, K1's device time over a 1-iteration fit (7
    trees; the profiler takes minutes over 140), the transform's
    rows/s, the training ``multi_logloss`` falling every iteration,
    probabilities summing to 1 (1e-5), the card's raw scores within 1e-5
    of the CPU's and accuracy at least twice chance;
17. fits ``LightGBMRegressor`` on that continuous target (``regression``
    timed, ``huber`` and ``regression_l1``, each RMSE below the target's
    std), then an early-stopped fit (``earlyStoppingRound=3``, 50
    iterations) whose validation rows, the last 10 %, have their targets
    shuffled: it must stop at ``best_iteration + 3``, score
    ``best_iteration + 1`` iterations, and report a last validation RMSE
    equal to a recomputation from the booster (1e-5 relative); and a
    3-iteration fit against the plain histogram (the same tree-0 root,
    RMSE within 1e-3 relative);
18. fits the binary cell (phase 3's data and settings) with bagging and
    ``featureFraction``, GOSS, DART with ``featureFraction``, rf and
    ``posBaggingFraction``, one timed fit each after phase 3's fit as the
    warm-up, each AUC in (0.75, 1], GOSS's first row mask exactly
    ``top_n`` rows at 1 and ``other_n`` at 8, and each mode's 3-iteration
    fit against the plain histogram (the same tree-0 root, AUC within
    1e-3);
19. fits phase 3's rows plus two seeded categorical slots (12 and 200
    levels; the label's margin gains 1.0 on a seeded non-monotone half of
    the 200 levels) with ``categoricalSlotIndexes=[28, 29]`` through K1
    (the same nonzero launches in each timed fit, no plain call), holds a
    3-iteration fit against the plain histogram (the same tree-0 root,
    its left set included; AUC within 1e-3), the set split's AUC above an
    ordinal fit's, ``saveNativeModel`` → ``loadNativeModelFromString``
    (raw scores within 1e-6 on the card, 1e-5 of the CPU's), unseen,
    negative and non-integer category ids routed as missing ones (right),
    the loaded bitset read one bin late as a planted fault that must
    fail, and a ``maxBinByFeature`` fit whose capped slot splits at or
    below its 15th cut;
20. fits the padded-COO path on ``bench.py``'s hashed-text shape (200,000
    rows of 32 unique indices over 10,000 features, 10 iterations, 31
    leaves; no K1 launch), reads the histogram's device time from
    ``torch.profiler``, and holds a 20,000-row, 3-iteration card fit
    against ``device="cpu"`` (the same tree-0 root, AUC within 1e-3), COO
    scoring
    of 1,000 rows against the densified rows (1e-6) and a text-format
    round trip;
21. fits ``LightGBMRanker`` on ``bench.py``'s MSLR-WEB30K shape (1,000
    queries of 100 documents, 32 features, graded 0-4 relevance, 10
    iterations, 31 leaves) through K1, prints ndcg@1/3/5/10, and holds a
    3-iteration fit against the plain histogram (the same root, ndcg@10
    within 1e-3), the iteration-0 lambdarank gradients on the card
    against the CPU's (1e-5), ndcg@10 above a seeded random scoring's,
    and SHAP values of 256 rows of phase 19's model summing to their raw
    scores (1e-4);
22. fits phase 3's rows in two batches of 250,000 (10 iterations a batch)
    through ``numBatches=2``, ``fit_stream``, a ``modelString``
    continuation of batch 1's saved text and an ``initScoreCol`` fit on
    batch 2 from batch 1's raw scores: K1 launches 620 a two-batch fit and
    310 a batch, no plain call; batch 1's model and its text score batch 2
    bit for bit; the three paths' trees equal in structure, leaf values
    within 1e-5 (K1's shared-memory atomics move the last bits between
    fits), and the ``initScoreCol`` trees equal the continuation's;
23. spawns 2 ranks on ``cuda:0`` over gloo (250,000 rows a rank, 20
    iterations), data parallel and voting at ``topK=6``: K1 620 launches
    on each rank, each fit's seconds, all_reduce calls, bytes and host
    seconds inside them; data parallel's probabilities within 5e-3 and
    AUC within 0.002 of one rank's, voting's AUC within 0.02 of data
    parallel's;
24. runs BERT-base (``bert-base-uncased``'s published config: vocab
    30,522, width 768, 12 layers of 12 heads, mlp 3,072, 512 learned
    positions, the pooler) with seeded weights in the HuggingFace
    state-dict layout through ``bert_encoder_from_torch`` (bf16): the first
    fifth of each document through ``WordPieceTokenizerModel`` over a
    30,522-entry vocabulary built in-process (``maxLength`` 512), K2a held
    against its plain version at ``[32, 12, 512, 64]`` in bf16 and f32,
    then ``TextEncoderFeaturizer(model=LoadedModel(...))`` with ``pallas``
    (12 K2a launches a transform; seqs/s and non-pad tokens/s) held against
    ``dense`` with phase 6's limits and its planted fault;
25. trains phase 8's masked LM (batch 8) 3 steps, saves with
    ``CheckpointManager``, trains 3 more; restores into a fresh model and
    optimizer and runs the same 3 steps: losses and parameters must equal
    the uninterrupted run's (bit-equal expected, else within 1e-6
    relative), K2b, K2d and K2e 8 launches a step; prints save and restore
    seconds and bytes;
26. runs ``ContinuousGenerator`` over phase 10's LM (16 slots, ``max_len``
    258, phase 10's 32 prompts, 128 new each): K2c 8 launches a step,
    tokens/s and steps, every token re-scored (K2c one tile late must fail);
27. runs ``generate_speculative`` at k = 4 with a self-draft one row at a
    time on 2 prompts (tokens per pass at least 0.9 (k + 1)) and over the
    32 rows, and with a seeded depth-2 draft, then ``TextGenerator`` over
    ragged prompt strings through a ``BpeTokenizer`` fitted on the
    documents, without the draft on 32 and with it on the first 4 (one
    decode call per distinct length): K2c launches (the prefills),
    tokens/s, tokens per pass, every generated token re-scored;
28. runs phase 11's round 3 under ``MMLSPARK_TPU_PAGED_ATTN=0`` (the dense
    re-gather mode) and then paged in the same process: K3 and its combine
    0 launches, ``kv_dense_gather_bytes_total`` one gather per prefill
    batch and per decode step, tokens/s beside the paged mode's, every
    token re-scored;
29. runs ``ImageFeaturizer(modelName="ResNet50")``'s model at full width:
    a seeded torchvision-layout ResNet-50 state dict (every BatchNorm scale
    and running statistic non-zero) through ``resnet_from_torch``, 1,024
    seeded uint8 BGR images of 256 x 256, ``autoResize`` to 224, minibatches
    of 64: bf16 images/s (median of 3 warm transforms), the
    ``last_transform_stats``, the top device kernels and the busy share
    (``torch.profiler``); holds bf16 against f32 (TF32 off) by per-row
    cosine and max |diff|, the card's f32 against the port on the CPU (8
    rows, 1e-4), the resize against its formula in numpy (a resize without
    antialiasing must fail), and ``cutOutputLayers=2`` (``stage4``) against
    a numpy reshape of the model's NHWC endpoint (the endpoints in NCHW
    order must fail);
30. the same for ViT-B/16 (``vit_from_torch``; ``block12`` as the cut
    layer), with LayerNorm eps 1e-5 as the planted fault that must fail the
    CPU hold;
31. ``ImageFeaturizer(quantize=True)`` on phase 29's model: images/s beside
    bf16, the pooled mean cosine against f32 (>= 0.99), conv_init's int32
    product bit-equal on the card, the CPU and in int64 from the same int8
    inputs, and 8 rows' features the same alone and among 56 outlier rows;
32. an ``ImageTransformer`` chain (resize, crop, colorFormat, flip, blur,
    gaussianKernel, threshold) and ``UnrollImage`` over the images, card
    against ``device="cpu"`` (1e-5); ``save_converted`` then
    ``ImageFeaturizer(modelName="ResNet50")`` through ``ModelDownloader``,
    bit-equal to phase 29; a ``TextEncoderBase`` checkpoint by name
    (bit-equal to ``model=``) and with ``quantize=True`` (cosine against
    f32 >= 0.99). Every vision phase fails if K1, K2 or K3 launches, or a
    plain version runs;
33. drives the observability plane (``mmlspark_torch.obs``) on phases 3,
    8 and 11's data and models: phase 3's fit under a ``SpanCollector``
    (one ``lightgbm.fit`` span with a ``boosting_round`` child per
    iteration, the rounds' seconds within the fit's, the round histogram
    filled once a round, phase 3's K1 launches and no plain call) beside
    the same fit untraced; a ``torch.profiler`` capture
    (``XprofCaptures.region``) around one warm fit and one decode round of
    phase 11's 16-slot engine, whose exported K1 and K3 kernel events must
    equal the wrappers' launch deltas times the kernels a launch runs, with
    the ``device=True`` span names in it; ``device_memory_stats()`` against
    ``torch.cuda.memory_allocated``/``mem_get_info`` and a host-only
    process's scrape with the card visible, which must leave
    ``torch.cuda.is_initialized()`` False (and must see the context the
    same process then makes); phase 8's masked-LM step counted through the kernels and through
    the plain versions on the card (``obs.attribution.count_cost``: the
    counts must be equal) and its MFU against the H100 peak row, in (0,
    1.05]; a ``Timer``-wrapped transform of phase 3's model (synced, device
    seconds > 0, dispatch + device within 5 % of wall); and phase 11's
    ``compile_tracker`` stats after round 3 with the signatures that
    arrived after ``mark_steady``;
34. serves BERT-base (phase 24's seeded bf16 weights) through
    ``TextEncoderFeaturizer`` on K2a behind ``RequestScheduler`` with
    ``Tenancy`` (a gold tenant and a best-effort one with the reference's
    queue share, the reference's tier deadlines, the reference overload
    scenario's 0.2 s deadline, a queue of 512): 1,500 seeded single
    documents of 64-512 WordPiece tokens, half gold, offered on a seeded
    Poisson schedule at twice the sustainable rate (full batches of 32 a
    second, measured in the phase's warm pass, which runs every batch shape
    twice and lands its second pass as FeatureLog rows that fit the shared
    cost model); one executor thread pulls ``next_batch(max_batch=32)``,
    runs the featurizer, feeds the estimator and records a FeatureLog row
    a batch. Fails unless every request is answered or shed with one of
    the reference's reasons and a ``Retry-After`` > 0, the queue depth
    stays within its bound, no request is dispatched after its deadline,
    the registry's ``sched_admitted_total``/``sched_shed_total`` equal the
    phase's counts, K2a launched 12 times a batch, every served row agrees
    with the dense route within phase 24's bf16 limits, and gold's answered
    share is at least best effort's; prints each tenant's p50/p99, the
    batches, the EWMA beside the measured batch time, the cost model's and
    the EWMA's MAE over the last third of the batches and K2a's share of
    the executor's time. The same schedule through a scheduler whose
    expiry check is off (a planted fault) must break the deadline check.
    Last, ``CheckpointManager`` saves the encoder, a second save under a
    ``checkpoint.write`` drop must raise ``InjectedDrop`` and leave the
    store as it was, and ``restore()`` must give the first state back
    bit-equal on the card.
35. compiles the SURVEY §7.3 chain on numeric columns (``CleanMissingData``
    Mean → ``Featurize`` → ``LightGBMClassifier``, fitted on 500,000 x 30
    float32 features with ~5 % NaN; 620 K1 launches, no plain call) on a
    4,096-row example: the plan must be one fused segment of the two
    featurize models and the GBDT model eagerly; five compiled and five
    eager transforms of the 500,000 rows in turn (integer and bookkeeping
    columns equal, floats within 1e-6 relative, AUC within 1e-6; the
    median times printed), the tracker at one compile and five calls, no
    fallback, and the segment's body run on device tensors under
    ``torch.cuda.set_sync_debug_mode("error")``. Then builds an AOT store
    at a fresh root (the 500,000-row bucket and the K1, K2a-K2c, K3 window
    and K3 decode libraries) and boots a fresh ``python3`` from it with an
    empty kernel build directory: phase 11's engine (``warm()``'s
    fingerprints named as the JAX engine's and equal to this process's),
    ``warm_aot``, then a round of 16 prompts, the 500,000-row transform
    and ``generate`` on 4 prompts, with no nvcc, no runtime compile, store
    hits and no miss, bit-equal output and the same tokens as this
    process; the seconds from process start to the first token, cold (no
    store, empty build directory) and warm; last, one byte of K3 decode's
    stored library flipped must give one loud miss, one rebuild, one
    backfill and the same tokens.
36. tunes the kernels' tiles (``perf.autotune``; the run's registry is a
    fresh file named by ``MMLSPARK_TPU_TUNE_STORE``, set at the start for
    the run and its children, and phases 1-35 and 37 must have found no
    winner in it): K1 at phase 3's ``[500,000, 28]`` u8 bins with 256 bins
    (``feat_block`` x ``block_rows``), K2a at BERT-base's ``[32, 12, 512,
    64]`` bf16 and K2c at the generate prefill's ``[32, 8, 128, 64]``
    (``block_k`` x ``stages``: the default instance and
    ``csrc/flash_tuned.cu``'s) and K3's decode kernel at phase 9's decode
    row (32 slots, ``BL`` 16, 256 blocks, 8 heads of 64, bf16: ``chunk``
    x ``stage_positions``). Every candidate is first held against its
    plain version at the tolerance of that kernel's check, then timed by
    the tuner (one warm launch, then the best of 20 between CUDA events,
    L2 flushed); any discard fails. Each winner is timed against the
    default tiles in 16 alternating turns (each the median of 5 launches
    timed as the tuner times them). A fresh ``python3`` (``--tune-
    child``) loads the registry at import and runs a BERT-base transform,
    phase 3's fit, a 16-slot engine round over a 4,096-position table and
    ``generate`` on 4 prompts, tuned and then with the table cleared: every
    tuned key must be hit tuned and none untuned, the launch counts equal,
    the pooled rows within phase 24's bf16 limits, the AUCs within 1e-3
    and every token within phase 11's re-score limit. The kernels line's
    K1, ``flash_bert``, ``flash_causal`` and ``paged_attention`` records
    gain a ``tuned`` entry (the winner's tiles, its time and the
    default's).
37. serves two models over HTTP on both of the port's fronts, the
    threaded Python ``ServingServer`` and the epoll ``NativeServingServer``
    (each named; ``backend="auto"`` is never used, and the host libraries
    are built with g++ beside the kernels in phase 1): phase 35's chain,
    fitted here (620 K1 launches before any server starts) and served
    through ``ServingStream.compile_pipeline`` (one fused segment of the
    two featurize models, the GBDT model eagerly), and BERT-base (phase
    24's seeded bf16 weights, ``TextEncoderFeaturizer`` on K2a) through
    ``serving_query``. On each front 256 distinct chain rows and 64 of
    phase 34's requests (64-512 tokens) go through the port's
    ``AsyncClient`` at concurrency 16: every reply a 200, the chain's
    probabilities within 1e-6 relative of the direct transform (phase 35's
    limit) and the pooled rows within phase 24's limits of the direct
    transform. Then ``loadgen.run_load`` closed-loop (16 connections,
    warm-up 20, sized for at least 3 s a run) prints rows/s, p50/p99,
    ``shed_rate`` and errors, which must be 0. K1 makes no launch while
    serving and K2a exactly 12 per executor transform; the kernels line's
    K2a records gain ``serving_launches`` (or, run alone, the phase adds
    ``flash_serving`` at its own shape). It runs before the winner check,
    on the untuned kernels. Its fitted chain is kept for phase 38.
38. runs the serving mesh, the autoscaler and the deploy plane: a
    ``DriverRegistry`` and two ingest servers in this process (a
    ``DistributedServingServer`` on the threaded front and a
    ``NativeDistributedServingServer`` on the epoll front), and a fresh
    ``python3 chip_smoke.py --mesh-child`` running ``remote_worker_loop``
    for BERT-base (phase 24's seeded weights) with an empty kernel build
    directory, so only the AOT store (K2a's library at a fresh root) can
    supply K2a: its first leased request answered with no nvcc, no runtime
    compile, store hits and no miss, and K2a 12 a transform, the seconds
    from its spawn to its first reply printed. Every reply comes back
    through the ingest that received and owns its request (each ingest's
    ``__reply__`` is logged). 8 requests sent one at a time are bit-equal
    to the direct transform of the same row, 64 through ``AsyncClient``
    within phase 24's limits; ``loadgen.run_load`` (16 connections, at
    least 3 s) through each ingest, every status 200. An in-process
    ``ComputeWorkerPool`` worker is killed by the fault plane's
    ``worker.death`` while it holds a lease: every request in flight is
    answered 200 within phase 24's limits, leases replay, and the
    ``Autoscaler`` repairs the pool inside its cooldown. Then the deploy
    plane on the epoll front: phase 37's chain (v1) and the same chain
    fitted for 10 iterations (v2) in a ``ModelRegistry``; v2 staged as a
    0.25 canary and promoted by a ``RolloutController`` while 16 requests
    are held across the flip; each request's version is read from the
    router at admission, and every reply carries that version in
    ``X-Model-Version`` and equals its transform within 1e-6 relative (so
    the gated requests admitted on v1 complete on v1), ``/debug/deploy``
    shows the flip and the drained v1, and K1 makes no launch while
    serving. Four planted faults must each fail their check: a reply
    posted to the wrong owner, a lease whose replay is switched off, a
    version stamped at reply time, the executor picking the version at
    execute time. The kernels line's
    K2a records gain ``mesh_launches`` (the child's and this process's).
39. runs sequence and tensor parallelism (``mmlspark_torch.parallel``) in
    2 ranks on the card over gloo, spawned once, at full width (it runs
    before phase 36, so no tuned winner steers it): (a) one masked-LM step
    of phase 8's model at batch 8 x T=2048 (1,024 a rank) through
    ``make_attention_fn("ring_flash")`` over sp = 2, K2b, K2d and K2e 16
    each a rank (8 blocks x 2 ring steps), its loss and per-parameter
    gradients held against one rank's ``pallas`` step with phase 8's
    limits, each rank's peak memory beside the one rank's; (b) the same
    for phase 13's causal LM through the causal ring (K2c-lse, causal K2d
    and K2e 16 each a rank), and one fully masked ring step (rank 0's
    queries against rank 1's keys) that must give o = 0, lse = -1e30 and
    zero gradients; (c) phase 24's BERT-base through ``ulysses_flash``
    over sp = 2 (6 of 12 heads a rank, K2a 12 a rank a transform) on its
    32 documents, the pooled rows within phase 24's bf16 limits of one
    rank's ``pallas`` rows; (d) a tp = 2 step's gradients (K2b, K2d, K2e 8
    each a rank on 4 of 8 heads) against one rank's,
    ``pretrain_masked_lm(mesh=MeshSpec(dp=1, tp=2), dtype_policy=...)``
    for 3 steps, each loss within 1e-3 relative of one rank's and every
    block still its placement after them, and ``TextEncoderFeaturizer(
    mesh=MeshSpec(dp=2))`` over BERT-base on 33 documents (one padding
    row): 33 rows within phase 24's limits. Ring attention is held against
    one rank's kernel at the attention level, causal and not. Four planted
    faults must each fail their check: ``k_offset`` taken as 0 in the
    causal ring, one side of the lse merge dropped, a tp gradient not
    summed, the padding row kept. The kernels line's K2a, K2b, K2c-lse,
    K2d and K2e records gain ``parallel_launches`` (a rank's).

Any failed build, launch or comparison exits non-zero. Each phase prints
its seconds. The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. ``--rows``/``--iterations``/``--docs``/
``--batch``/``--train-steps``/``--new-tokens`` shrink the run for a quick
first check, and ``--phases`` runs some of the phase groups after the build
(``gbdt``: 2-4, ``text``: 5-6, ``train``: 7-8, ``llm``: 9-11, ``causal``:
12-13, ``featurize``: 14-15, ``breadth``: 16-18, ``breadth2``: 19-21,
``breadth3``: 22-23, ``textgen``: 24-28, ``vision``: 29-32, ``obs``: 33,
which needs ``gbdt``, ``train`` and ``llm``, ``control``: 34,
``compile``: 35, ``tune``: 36, ``serving``: 37, ``mesh``: 38,
``parallel``: 39).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

F32_EPS = float(np.finfo(np.float32).eps)
# grad/hess channels: two f32 summation orders of the same m terms differ by
# at most ~m·eps·Σ|x| in the worst case and ~sqrt(m)·eps·Σ|x| typically;
# 64·eps·Σ|x| per cell covers the typical case for m up to ~4000 rows per
# cell with room to spare. The count channel sums 0/1 weights and must match
# exactly.
SUM_TOL_EPS = 64
H100_BUS_BITS = 5120          # HBM3 interface of the H100 (NVIDIA data sheet)
F32_PEAK_FLOPS = 67e12        # H100 SXM, non-tensor-core f32 (data sheet)
TF32_PEAK_FLOPS = 495e12      # H100 SXM, dense TF32 tensor cores (data sheet)
FIT_RUNS = 3                  # warm fits timed in phase 3 (median reported)
BF16_PEAK_FLOPS = 989e12      # H100 SXM, dense bf16 tensor cores (data sheet)
BF16_EPS = 2.0 ** -7          # bf16 spacing at 1 (8 significand bits)
# K2a in bf16 against its plain version: both round the f32 result to bf16
# once, after summing in two different orders (the kernel's key tiles and
# mma.sync, the plain version's one dense product), and round the
# unnormalised p to bf16 against different running maxima; so outputs may
# differ by one bf16 ulp (2^-7 relative, taken twice for margin) plus a
# small absolute term for outputs near 0 whose p roundings do not cancel.
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 2 * BF16_EPS, 4e-3
# f32: the same arithmetic in two summation orders over <= 2048 keys
FLASH_F32_ATOL = 2e-5
# the text path: pallas against dense pooled embeddings after 8 bf16
# blocks (the attention outputs differ by bf16 roundings, see above, and
# the residual stream carries them through every later block). The
# sinusoidal positions add a part common to every row that no attention
# fault moves, so the cosine is also taken after subtracting the dense
# rows' mean; a planted fault (K2a with the key mask dropped) must fail
# these limits. (raw cosine floor, centred cosine floor, max |diff|)
POOLED_LIMITS = (0.99999, 0.9999, 5e-3)
# the same comparison for the trunk after phase 8's 16 AdamW steps: its
# rows share more of their pooled vector than the random encoder's, so the
# same bf16 noise weighs more in the centred cosine and in |diff| (first
# full-size readings 0.9964787 and 0.006342, PERF.md §6); limits ~3-6x
# those, and the planted fault must fail them here too.
TRUNK_POOLED_LIMITS = (0.99999, 0.98, 0.02)
TEXT_SHAPE = dict(vocab=32768, width=512, depth=8, heads=8, mlp_dim=2048)
TEXT_T = 2048
TRANSFORM_RUNS = 3            # warm transforms timed in phase 6 (median)
# K2b's lse against its plain version: the logsumexp in f32 of the same
# scores summed in other orders (l to ~1e-6 relative, so lse to ~1e-6);
# 1e-4 leaves room for two libraries' exp and log.
LSE_ATOL = 1e-4
# K2d/K2e in bf16 against their plain versions, which take the same inputs
# (q, k, v, dO, lse, dsum) and round at the same points: the f32 sums differ
# in order only, so the final bf16 rounding of dq/dk/dv may differ by one
# ulp (2^-7 relative, taken twice for margin); for elements near 0 a ds or p
# whose bf16 rounding falls the other way in the two orders moves the sum by
# a fraction of one term, covered by one bf16 ulp of the tensor's largest
# element.
BWD_BF16_RTOL, BWD_BF16_ATOL_OF_MAX = 2 * BF16_EPS, BF16_EPS
# f32: the same arithmetic in other summation orders over <= 2048 terms and
# expf against PyTorch's exp: ~1e-6 relative expected; 1e-4 of the tensor's
# largest element (and of each element) leaves room and still fails any
# wrong term.
BWD_F32_RTOL, BWD_F32_ATOL_OF_MAX = 1e-4, 1e-4
TRAIN_BATCH = 8               # bench.py:693's text-encoder training batch
TRAIN_RUNS = 3                # timed pretraining windows in phase 8
# phase 8: per-parameter gradients through the kernels (pallas) against
# autograd through dense attention, same weights and batch. Readings at
# batch 8: worst ||dg||/||g|| 9.2e-3, cosine 0.99996, |dloss| 1.2e-5
# (PERF.md §6); the limits leave 5x, 24x and 80x, and a planted fault
# (K2d/K2e with dsum zeroed, 2.4 and 0.39) must fail them.
GRAD_REL_MAX = 0.05
GRAD_COS_MIN = 0.999
LOSS_ABS_MAX = 1e-3
# the LLM slice: bench.py:931-951's generation traffic (32 prompts of 129
# tokens, 128 new tokens, greedy)
GEN_BATCH, GEN_T, GEN_NEW = 32, 129, 128
# K3 against its plain version: the online softmax over chain tiles against
# one dense product over the gathered chain, as K2a against its plain
# version (one final bf16 rounding after other summation orders, p rounded
# against other running maxima); f32 over <= 4096 keys as K2a's f32
PAGED_BF16_RTOL, PAGED_BF16_ATOL = FLASH_BF16_RTOL, FLASH_BF16_ATOL
PAGED_F32_ATOL = FLASH_F32_ATOL
# re-scoring generated tokens with the dense causal forward: every chosen
# token's dense logit lies within RESCORE_DELTA of the dense maximum. The
# kernels and dense attention differ by bf16 roundings through 8 blocks, so
# near-ties among 32,768 random-weight logits flip; a planted fault (K2c
# one tile late, K3 with pos ignored) must fail the limit.
RESCORE_DELTA = 0.25
# phase 13: the trained causal LM generates 32 tokens after 8 prompts of
# 129 document tokens, each re-scored as in phase 10 (RESCORE_DELTA); its
# causal forward through K2c is held against the dense one logit by logit
# at the generated positions. First full-size readings: max |dlogit| 0.0100
# through the kernels, 0.1241 with K2c one tile late (PERF.md §6); the
# limit leaves 4x the first and is 3x under the second.
CAUSAL_GEN_NEW = 32
LOGIT_DRIFT_MAX = 0.04
# phase 13: a remat=True step recomputes each block's forward with the same
# deterministic kernels on the same inputs, so its loss and gradients
# should equal the plain step's; the limits only leave room for a GEMM
# that picks another algorithm on the recompute
REMAT_LOSS_MAX = 1e-6
REMAT_GRAD_REL_MAX = 1e-5
# self-draft speculation accepts every proposal on the CPU; on the card the
# draft's width-1 walks and the target's width-5 walk round differently, so
# a near-tie may part them
SPEC_ACCEPT_MIN = 0.9


# what phases 3, 8 and 11 leave for phase 33 (their frame, models, engine)
OBS: dict = {}
# phase 33: a Timer's dispatch + device seconds against the wall around it
TIMER_WALL_SHARE = 0.05
# phase 33: captures taken before one shows every kernel the wrappers
# launched. torch.profiler on the H100 drops records now and then (a
# session's first kernel records, a whole host trace, once a capture's
# last ~1 s of kernels); a capture that shows fewer events of some
# wrapper's kernel than it launched, and more of none, is retaken and
# never counted. One that shows more fails at once
CAPTURE_ATTEMPTS = 3
# phase 33: MFU above 1 is a wrong count or a wrong clock
MFU_MAX = 1.05
# phase 33: a host-only process's scrape, with the card visible, must not
# create a context; the same scrape after the process makes one (a
# tensor on the card) must see it, or the check could not fail
HOST_SCRAPE = r"""
import json
import torch
import mmlspark_torch.obs as obs


def scrape():
    stats = obs.device_memory_stats()
    obs.memory_profiler.update()
    obs.fleet_health.tick()
    obs.registry.exposition()
    return {"stats": stats, "initialized": torch.cuda.is_initialized(),
            "mem_gauges": any(k.startswith("mem_hbm_")
                              for k in obs.registry.snapshot())}


host = scrape()
torch.cuda.init()
x = torch.ones(1024, device="cuda")
print(json.dumps({"host": host, "card": scrape()}))
"""


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi(query: str, units: bool = True) -> str:
    fmt = "csv,noheader" + ("" if units else ",nounits")
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          f"--format={fmt}"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def higgs_like(rows: int):
    """bench.py's GBDT workload: 28 normal features, labels from a margin
    with an interaction term plus noise (seed 7)."""
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(rows, 28)).astype(np.float32)
    margin = feats[:, :4].sum(1) + feats[:, 4] * feats[:, 5]
    labels = (margin + rng.normal(size=rows) > 0).astype(np.float32)
    return feats, labels


def time_ms(fn, torch, *, runs: int = 25, warmup: int = 3,
            flush=None) -> float:
    """Median device time of ``fn`` over ``runs`` launches, each between
    its own pair of CUDA events, after ``warmup`` calls. ``flush`` (a large
    tensor) is overwritten before each run so inputs come from HBM, not
    from the 50 MB L2."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def memory_bandwidth(torch) -> tuple[float, str]:
    """Peak device-memory bytes/s: 2 transfers per memory clock times the
    bus width. The clock and width come from the device properties where
    PyTorch exposes them, else the clock from nvidia-smi and the H100's
    5120-bit bus."""
    prop = torch.cuda.get_device_properties(0)
    clock_khz = getattr(prop, "memory_clock_rate", None)
    bus = getattr(prop, "memory_bus_width", None)
    if clock_khz and bus:
        return 2 * clock_khz * 1e3 * bus / 8, \
            f"device properties: {clock_khz / 1e3:.0f} MHz x {bus} bit"
    mhz = float(nvidia_smi("clocks.max.memory", units=False))
    return 2 * mhz * 1e6 * H100_BUS_BITS / 8, \
        f"nvidia-smi clocks.max.memory {mhz:.0f} MHz x {H100_BUS_BITS} bit"


def check_hist(torch, k1, name, bins, vals, B, count=None, tiles=None):
    """Hold hist_cuda (at ``tiles``, its ``feat_block``/``block_rows``, if
    given) against hist_torch on one input; returns the largest grad/hess
    difference."""
    want = k1.hist_torch(bins, vals, num_bins=B, count=count)
    got = k1.hist_cuda(bins, vals, num_bins=B, count=count, **(tiles or {}))
    scale = k1.hist_torch(bins, vals.abs(), num_bins=B, count=count)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"K1 {name}: non-finite output")
    if not torch.equal(got[..., 2], want[..., 2]):
        fail(f"K1 {name}: count channel differs from the plain version "
             f"(max |diff| {(got[..., 2] - want[..., 2]).abs().max():.6g})")
    diff = (got[..., :2] - want[..., :2]).abs()
    limit = SUM_TOL_EPS * F32_EPS * scale[..., :2]
    if (diff > limit).any():
        worst = int(torch.argmax(diff - limit))
        fail(f"K1 {name}: grad/hess outside {SUM_TOL_EPS}*eps*sum|x| "
             f"(worst flat cell {worst}: |diff| "
             f"{diff.reshape(-1)[worst]:.6g} > "
             f"{limit.reshape(-1)[worst]:.6g})")
    err = float(diff.max())
    print(f"K1 {name}: count exact, grad/hess max |diff| {err:.3g} "
          f"(limit {SUM_TOL_EPS}*eps*sum|x| per cell)")
    return err


_KERNEL = re.compile(r"(hist_partial|flash_fwd_bf16|flash_fwd_f32|"
                     r"flash_fwd_tuned|"
                     r"bwd_dq_bf16|bwd_dkv_bf16|bwd_dq_f32|bwd_dkv_f32|"
                     r"paged_fwd_bf16|paged_f32|paged_decode|paged_combine|"
                     r"wide_fwd|wide_dq|wide_dkv|split_fwd|split_dq|"
                     r"split_dkv)I(\w*?)E+v|(hist_reduce)")


def _template_args(mangled: str) -> list[str]:
    """The template arguments of a mangled kernel name: the element type
    (bf16/f32, or K1's bin type), the key source of the wide forward
    (dense/paged), then the integers (head dim, flags, window rows)."""
    dtype = ("bf16" if "__nv_bfloat16" in mangled else
             "f32" if mangled.startswith("f") else None)
    src = [k.lower() for k in ("Dense", "Paged")
           if re.search(rf"NS_\d+{k}(Keys)?[EI]", mangled)]
    args = ([dtype] if dtype else []) + src + re.findall(r"L[ib](\d+)",
                                                         mangled)
    return args or [{"h": "u8", "i": "i32"}.get(mangled, mangled)]


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel from nvcc's ``-Xptxas -v`` output: its name with
    the template arguments (head dim, then the kLse and kCausal flags; the
    element type, key source and window rows of the wide and decode
    instances; or the bin type), registers, shared memory and any
    spills."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = _KERNEL.search(line)
            name = (line.split("'")[1] if m is None else m.group(3) or
                    f"{m.group(1)}<" + ",".join(_template_args(m.group(2)))
                    + ">")
        elif "spill" in line and name is not None:
            spill = re.findall(r"(\d+) bytes spill", line)
            spills = "" if set(spill) <= {"0"} else \
                f", spills {spill[0]} B stores / {spill[1]} B loads"
        elif "Used" in line and name is not None:
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name}: {regs.group(1) if regs else '?'} registers, "
                       f"{smem.group(1) if smem else 0} B smem{spills}")
            name = None
        elif "error" in line.lower():
            out.append(line.strip())
    return out


# ptxas spill bytes (stores, loads) each instance may show: what the bf16
# backward redesign left (PERF.md §6); any other instance, the bf16
# forward's and K3's window kernel's included, none, and the decode
# kernel's, its combine's and the wide kernels' (the cluster instances and
# the split ones beyond them) are listed at none. More fails phase 1.
SPILL_LIMITS = {"bwd_dkv_bf16<32,0>": (4, 4), "bwd_dkv_bf16<32,1>": (8, 20),
                "bwd_dkv_bf16<64,0>": (4, 4), "bwd_dkv_bf16<128,1>": (64, 104),
                "bwd_dkv_bf16<256,0>": (4, 4), "bwd_dkv_bf16<256,1>": (4, 4),
                **{f"paged_decode<{t},{w}>": (0, 0) for t in ("bf16", "f32")
                   for w in (1, 8, 16)},
                **{f"{k}<{t}{src}>": (0, 0) for t in ("bf16", "f32")
                   for k, src in (("paged_combine", ""), ("wide_dq", ""),
                                  ("wide_dkv", ""), ("wide_fwd", ",dense"),
                                  ("wide_fwd", ",paged"), ("split_dq", ""),
                                  ("split_dkv", ""), ("split_fwd", ",dense"),
                                  ("split_fwd", ",paged"))}}


def start_builds(builders: dict) -> dict:
    """Start every kernel's build at once (each is one nvcc process);
    returns ``{name: future of (seconds, nvcc output)}``."""
    def timed(fn):
        t0 = time.perf_counter()
        log = fn()
        return time.perf_counter() - t0, log

    ex = ThreadPoolExecutor(len(builders))
    futures = {name: ex.submit(timed, fn) for name, fn in builders.items()}
    ex.shutdown(wait=False)
    return futures


def finish_builds(futures: dict) -> None:
    """Wait for the builds in ``futures`` and print each one's seconds and
    ptxas lines. A failed build fails, and so does a spill above
    ``SPILL_LIMITS``."""
    for name, fut in futures.items():
        try:
            secs, log = fut.result()
        except RuntimeError as e:
            fail(f"building {name}: {e}")
        print(f"  {name}: {secs:.2f} s")
        for line in ptxas_summary(log):
            print(f"    {line}")
            spill = re.search(r"spills (\d+) B stores / (\d+) B loads", line)
            limit = SPILL_LIMITS.get(line.split(":")[0], (0, 0))
            if spill and any(int(b) > lim
                             for b, lim in zip(spill.groups(), limit)):
                fail(f"ptxas spilled more than {limit[0]} B stores / "
                     f"{limit[1]} B loads: {line}")


def make_documents(n: int, seed: int = 5):
    """``n`` documents of words drawn from a seeded made-up vocabulary of
    20,000 lowercase words; word counts spread over 1,024-2,048, the first
    exactly 2,048. Returns the texts and the word counts (each word is one
    token for ``TokenIdEncoder``'s ``\\W+`` split)."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = np.array(["".join(rng.choice(letters, size=rng.integers(2, 10)))
                      for _ in range(20_000)], dtype=object)
    lengths = rng.integers(1024, TEXT_T + 1, size=n)
    lengths[0] = TEXT_T
    texts = np.array([" ".join(vocab[rng.integers(0, len(vocab), size=m)])
                      for m in lengths], dtype=object)
    return texts, lengths


def check_flash(torch, k2, name, q, k, v, mask, rtol, atol, tiles=None):
    """Hold flash_cuda (at ``tiles``, its ``block_k``/``stages``, if given)
    against flash_torch on one input; rows whose mask is all False must be
    exactly 0. Returns the largest |difference|."""
    want = k2.flash_torch(q, k, v, mask)
    got = k2.flash_cuda(q, k, v, mask, **(tiles or {}))
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"K2a {name}: {got.dtype} {tuple(got.shape)} vs plain "
             f"{want.dtype} {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"K2a {name}: non-finite output")
    empty = ~mask.any(1)
    if bool(empty.all()):
        fail(f"K2a {name}: every row is fully masked; the hold would "
             "compare zeros with zeros")
    if not (got[empty] == 0).all():
        fail(f"K2a {name}: a fully masked row is not exactly 0")
    diff = (got.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    if (diff > limit).any():
        worst = int(torch.argmax(diff - limit))
        fail(f"K2a {name}: outside atol {atol:g} + rtol {rtol:g} (worst flat "
             f"element {worst}: |diff| {diff.reshape(-1)[worst]:.6g} > "
             f"{limit.reshape(-1)[worst]:.6g})")
    err = float(diff.max())
    print(f"K2a {name}: max |diff| {err:.3g} (atol {atol:g}, rtol {rtol:g}); "
          f"{int(empty.sum())} fully masked row(s) exactly 0")
    return err


def agreement(got, dense) -> tuple:
    """The smallest per-row cosine of pooled embeddings ``got`` against
    ``dense``, raw and centred on the dense rows' mean, and max |diff|."""
    def min_cos(a, b):
        return float(((a * b).sum(1) / (np.linalg.norm(a, axis=1)
                                        * np.linalg.norm(b, axis=1))).min())
    centre = dense.mean(0)
    return (min_cos(got, dense), min_cos(got - centre, dense - centre),
            float(np.abs(got - dense).max()))


def pooled_agreement(name, got, dense, limits) -> bool:
    """:func:`agreement` of ``got`` against ``dense``; True when all three
    are within ``limits`` (raw floor, centred floor, max |diff|)."""
    cos_floor, centred_floor, max_abs = limits
    cos, ccos, delta = agreement(got, dense)
    ok = cos >= cos_floor and ccos >= centred_floor and delta <= max_abs
    print(f"{name} vs dense pooled embeddings: per-row cosine min "
          f"{cos:.7f} (floor {cos_floor}), centred {ccos:.7f} (floor "
          f"{centred_floor}), max |diff| {delta:.4g} (limit {max_abs}): "
          f"{'within' if ok else 'outside'} the limits")
    return ok


def hold_pooled(torch, k2, dev, phase, module, ids, pooled, dense, limits):
    """Hold the pallas pooled embeddings against dense ones within
    ``limits``, then show that the limits catch a faulty attention: the
    same encoder through K2a with the key mask dropped must fail them."""
    print(f"{phase}: dense pooled |x| median {np.median(np.abs(dense)):.4g}, "
          f"max {np.abs(dense).max():.4g}; centred on the rows' mean, median "
          f"{np.median(np.abs(dense - dense.mean(0))):.4g}")
    if not pooled_agreement(f"{phase}: pallas", pooled, dense, limits):
        fail(f"{phase}: pallas and dense pooled embeddings disagree beyond "
             "the stated tolerance")
    no_mask = module.with_attention(
        lambda q, k, v, key_mask=None: k2.flash_cuda(q, k, v, None))
    with torch.inference_mode():
        faulty = no_mask.to(dev).eval()(torch.from_numpy(
            np.asarray(ids)).to(dev))["pooled"].float().cpu().numpy()
    del no_mask
    if pooled_agreement(f"{phase}: planted fault (key mask dropped)", faulty,
                        dense, limits):
        fail(f"{phase}: the pooled-embedding limits pass K2a with the key "
             "mask dropped: they cannot tell a faulty attention")


def text_phases(torch, k1, k2, dev, bw, flush, texts, lengths):
    """Phases 5 and 6: K2a against its plain version, then the text path at
    full width. Returns K2a's record for the kernels line."""
    import torch.nn.functional as F
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.dl import TextEncoderFeaturizer
    from mmlspark_torch.featurize import TokenIdEncoder
    from mmlspark_torch.models import LoadedModel, register_text_encoder

    B, T = len(texts), TEXT_T
    H, W = TEXT_SHAPE["heads"], TEXT_SHAPE["width"]
    D = W // H

    # ---- phase 5: K2a against the plain version at the path's shapes
    mask_np = np.arange(T)[None, :] < lengths[:, None]
    mask_np[-1] = False                           # one fully masked row
    mask = torch.from_numpy(mask_np).to(dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    qkv = torch.randn(B, T, 3 * W, generator=gen, device=dev,
                      dtype=torch.bfloat16)
    # the encoder's layout: views of one fused projection, no copies
    q, k, v = (a.view(B, T, H, D).transpose(1, 2)
               for a in qkv.split(W, dim=-1))
    max_err = check_flash(torch, k2, f"bf16 B={B} H={H} T={T} D={D}",
                          q, k, v, mask, FLASH_BF16_RTOL, FLASH_BF16_ATOL)
    Bf, Tf = min(B, 8), 2000
    qf, kf, vf = (torch.randn(Bf, H, Tf, D, generator=gen, device=dev)
                  for _ in range(3))
    mask_f = mask[:Bf, :Tf].clone()
    mask_f[0] = False
    check_flash(torch, k2, f"f32 ragged B={Bf} H={H} T={Tf} D={D}",
                qf, kf, vf, mask_f, 0.0, FLASH_F32_ATOL)
    del qf, kf, vf
    # 16, 96, 192 and 320 run zero-padded to the kernel's 32, 128, 256 and
    # 384; above 256 in bf16 and 128 in f32 on the wide instances
    for d in HEAD_DIMS_HELD:
        for dtype in (torch.bfloat16, torch.float32):
            x = [torch.randn(2, 4, 300, d, generator=gen, device=dev,
                             dtype=dtype) for _ in range(3)]
            bf16 = dtype == torch.bfloat16
            check_flash(torch, k2, f"{str(dtype)[6:]} B=2 H=4 T=300 D={d}",
                        *x, mask_f[:2, :300],
                        FLASH_BF16_RTOL if bf16 else 0.0,
                        FLASH_BF16_ATOL if bf16 else FLASH_F32_ATOL)
    # the wider clusters (4-16 CTAs) and the split kernels beyond them
    mask_h = wide_hold_mask(torch, dev)
    for d, dtype, label in wide_held(torch):
        x = [torch.randn(2, 2, 200, d, generator=gen, device=dev,
                         dtype=dtype) for _ in range(3)]
        bf16 = dtype == torch.bfloat16
        check_flash(torch, k2, f"{str(dtype)[6:]} B=2 H=2 T=200 D={d} "
                    f"({label})", *x, mask_h,
                    FLASH_BF16_RTOL if bf16 else 0.0,
                    FLASH_BF16_ATOL if bf16 else FLASH_F32_ATOL)
    for d, dtype in WIDE_FAULT_DIMS:
        wide_fault(torch, k2, [torch.randn(
            2, 2, 200, d, generator=gen, device=dev, dtype=getattr(
                torch, dtype)) for _ in range(3)], mask_h)
    for x, mask_w in wide_inputs(torch, gen, dev, 3):
        time_wide(torch, "phase 5", "K2a", x, lambda: k2.flash_cuda(
            *x, mask_w), lambda: k2.flash_torch(*x, mask_w),
            4 * wide_pairs(mask_w, x[0].shape[1]), 4, bw, flush,
            wide_sdpa(torch, x, mask_w, flush=flush))

    ms = time_ms(lambda: k2.flash_cuda(q, k, v, mask), torch, flush=flush)
    plain_ms = time_ms(lambda: k2.flash_torch(q, k, v, mask), torch,
                       runs=10, flush=flush)
    sdpa_mask = mask[:, None, None, :]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=sdpa_mask), torch, flush=flush)
    # the work this mask needs: every query row against the valid keys of
    # its document (the kernel skips key tiles with no valid key)
    valid = int(mask.sum())
    ops = 4 * H * D * T * valid
    bytes_moved = 2 * (2 * B * H * T * D + 2 * H * D * valid) + B * T
    bound_ops_ms = ops / BF16_PEAK_FLOPS * 1e3
    bound_bytes_ms = bytes_moved / bw * 1e3
    bound_ms = max(bound_ops_ms, bound_bytes_ms)
    bound_by = "operations" if bound_ops_ms >= bound_bytes_ms else "bytes"
    print(f"phase 5: K2a {ms:.4f} ms; plain {plain_ms:.4f} ms; "
          f"scaled_dot_product_attention {library_ms:.4f} ms; bound "
          f"{bound_ms:.4f} ms by {bound_by} ({ops / 1e9:.1f} GFLOP over "
          f"{valid} valid keys at 989 TFLOP/s; {bytes_moved / 1e6:.1f} MB); "
          f"median of CUDA-event runs, L2 flushed")
    del q, k, v, qkv

    # ---- phase 6: raw text → token ids → pooled embeddings at full width
    df = DataFrame({"text": texts})
    t0 = time.perf_counter()
    ids = TokenIdEncoder(maxLength=T, vocabSize=TEXT_SHAPE["vocab"]) \
        .transform(df)
    tokenize_s = time.perf_counter() - t0
    tokens = int((ids["tokens"] != 0).sum())
    if not np.array_equal((ids["tokens"] != 0).sum(1), lengths):
        fail("TokenIdEncoder's non-pad counts differ from the word counts")
    schema = register_text_encoder("TextEncoderLong", seq_len=T,
                                   **TEXT_SHAPE)
    t0 = time.perf_counter()
    loaded = LoadedModel(schema, schema.builder(
        generator=torch.Generator().manual_seed(0)))
    init_s = time.perf_counter() - t0
    kw = dict(vocabSize=TEXT_SHAPE["vocab"], width=W,
              depth=TEXT_SHAPE["depth"], heads=H, model=loaded)
    stage = TextEncoderFeaturizer(attentionImpl="pallas", **kw)
    stage.transform(ids)                          # warm-up
    torch.cuda.synchronize()
    times, counts = [], []
    for _ in range(TRANSFORM_RUNS):
        k1.hist_cuda.launches = k2.flash_cuda.launches = 0
        t0 = time.perf_counter()
        out = stage.transform(ids)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts.append((k2.flash_cuda.launches, k1.hist_cuda.launches))
    transform_s = float(np.median(times))
    launches = counts[-1][0]
    if any(c != (TEXT_SHAPE["depth"], 0) for c in counts):
        fail(f"(K2a, K1) launches per transform {counts}: expected "
             f"({TEXT_SHAPE['depth']}, 0), one K2a launch per block")
    pooled = out["features"]
    if pooled.shape != (B, W) or pooled.dtype != np.float32 \
            or not np.isfinite(pooled).all():
        fail(f"pooled embeddings {pooled.dtype} {pooled.shape}, "
             f"{(~np.isfinite(pooled)).sum()} non-finite")
    print(f"phase 6: tokenized {B} documents ({tokens} tokens) on the host "
          f"in {tokenize_s:.3f} s; seeded encoder init {init_s:.2f} s; warm "
          f"transform {transform_s:.4f} s, median of {TRANSFORM_RUNS} "
          f"({', '.join(f'{t:.4f}' for t in times)} s): "
          f"{B / transform_s:.2f} seqs/s, {tokens / transform_s:,.0f} "
          f"non-pad tokens/s; K2a launches per transform {launches}")

    k2.flash_cuda.launches = 0
    dense = TextEncoderFeaturizer(attentionImpl="dense", **kw) \
        .transform(ids)["features"]
    if k2.flash_cuda.launches != 0:
        fail("the dense transform launched K2a")

    hold_pooled(torch, k2, dev, "phase 6", loaded.module, ids["tokens"],
                pooled, dense, POOLED_LIMITS)
    return {"name": "flash", "route": "cuda",
            "source": "mmlspark_torch/dl/csrc/flash_attn.cu",
            "replaces": "mmlspark_tpu/dl/pallas_attention.py:77",
            "launches": launches, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def hold(torch, name, got, want, rtol, atol):
    """Hold a kernel's output against its plain version: every element
    within ``atol + rtol * |want|``. Returns the largest |difference|."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {got.dtype} {tuple(got.shape)} vs plain {want.dtype} "
             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    if got.numel() == 0:
        return 0.0
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    limit = atol + rtol * w.abs()
    if (diff > limit).any():
        worst = int(torch.argmax(diff - limit))
        fail(f"{name}: outside atol {atol:.4g} + rtol {rtol:g} (worst flat "
             f"element {worst}: |diff| {diff.reshape(-1)[worst]:.6g} > "
             f"{limit.reshape(-1)[worst]:.6g}; max|ref| "
             f"{float(w.abs().max()):.4g})")
    return float(diff.max())


def hold_grad(torch, name, got, want, rtol, of_max):
    """``hold`` with the absolute term a fraction of the largest |want|."""
    return hold(torch, name, got, want, rtol,
                of_max * float(want.float().abs().max()))


# head dims every attention route is held at: 16, 96, 192 and 320 padded
# (to 32, 128, 256, 384); above 256 in bf16 and 128 in f32 on the wide
# instances, split over D
HEAD_DIMS_HELD = (16, 32, 64, 96, 128, 192, 256, 320, 512)
# the wide instances' timed shape: [B, H, T] at D = 512 in bf16 and 256 in
# f32 (their widths on the card); times are recorded, with no limit
WIDE_TIMED = (2, 8, 1024)
# head dims held beside HEAD_DIMS_HELD in phases 5, 7, 9 and 12: the
# wider clusters (flash_attention.wide_plan: bf16 1024 in 4 CTAs, 8 in
# K2e; bf16 2048 in 8, K2e in 16; f32 1024 in 8) and the split kernels
# beyond them (bf16 2176, f32 1152)
WIDE_HELD = ((1024, "bfloat16"), (2048, "bfloat16"), (1024, "float32"),
             (2176, "bfloat16"), (1152, "float32"))
# the wide forward's planted fault: clusters of 4 CTAs in both dtypes
WIDE_FAULT_DIMS = ((1024, "bfloat16"), (512, "float32"))


def wide_held(torch):
    """(D, dtype, route label) of each of WIDE_HELD: the CTAs of the
    forward's clusters and of K2e's, or the split kernels."""
    from mmlspark_torch.dl.flash_attention import wide_plan
    for d, name in WIDE_HELD:
        dtype = getattr(torch, name)
        fwd, dkv = (wide_plan(d, dtype, kernel).ctas
                    for kernel in ("fwd", "dkv"))
        yield d, dtype, (f"{fwd}-CTA clusters, K2e {dkv}" if fwd
                         else "split")


def wide_hold_mask(torch, dev, T=200):
    """A [2, T] key mask for the wide holds: most keys valid, the first
    row's last half and the second row's first 7 keys not (key tiles with
    no valid key, and partly valid ones)."""
    mask = torch.ones(2, T, dtype=torch.bool, device=dev)
    mask[0, T // 2:] = False
    mask[1, :7] = False
    return mask


def wide_inputs(torch, gen, dev, n, dims=((512, "bfloat16"),
                                          (256, "float32"))):
    """``n`` tensors [B, H, T, D] of WIDE_TIMED at each (D, dtype) of
    ``dims`` (by default D = 512 in bf16 and 256 in f32), each with a key
    mask (the first row's last 100 keys invalid)."""
    B, H, T = WIDE_TIMED
    mask = torch.ones(B, T, dtype=torch.bool, device=dev)
    mask[0, -100:] = False
    for d, name in dims:
        dtype = getattr(torch, name)
        yield [torch.randn(B, H, T, d, generator=gen, device=dev,
                           dtype=dtype) for _ in range(n)], mask


def wide_pairs(mask, H, causal=False):
    """Allowed (query, key) pairs over all heads: every row against the
    valid keys (causal: the valid keys at or before it)."""
    if causal:
        return H * int(mask.long().cumsum(1).sum())
    return H * mask.shape[1] * int(mask.sum())


def wide_sdpa(torch, x, mask, causal=False, dout=None, flush=None):
    """``scaled_dot_product_attention`` on the wide inputs ``x`` with the
    kernels' mask (the key mask, and the causal one with ``causal``): its
    forward alone, and with ``dout`` also its backward (forward + backward
    less the forward), in ms: the library yardstick of the wide rows."""
    allowed = mask[:, None, None, :]
    if causal:
        T = mask.shape[1]
        allowed = allowed & torch.ones(T, T, dtype=torch.bool,
                                       device=mask.device).tril()
    if dout is None:
        import torch.nn.functional as F
        return time_ms(lambda: F.scaled_dot_product_attention(
            *x[:3], attn_mask=allowed), torch, runs=10, flush=flush)
    return sdpa_times(torch, *x[:3], dout, flush, attn_mask=allowed)


def wide_peak(torch, dtype):
    """The peak a wide-head-dim kernel's bound takes for ``dtype``, and its
    label: 989 TFLOP/s for bf16 (the tensor cores); for f32 the card's
    fastest f32-exact product, 3xTF32 (three TF32 products each at 495
    TFLOP/s), whichever engine the kernel runs on (the split kernels run
    on the CUDA cores at 67 TFLOP/s)."""
    if dtype == torch.float32:
        return TF32_PEAK_FLOPS / 3, "495 / 3 TFLOP/s, 3xTF32"
    return BF16_PEAK_FLOPS, "989 TFLOP/s, bf16 tensor cores"


def time_wide(torch, phase, kid, x, run, plain, ops_per_d, n_tensors, bw,
              flush, library_ms, nbytes=None):
    """Time a wide-head-dim kernel on ``x`` beside its plain version, its
    bound (``ops_per_d`` x D operations at :func:`wide_peak`'s rate;
    ``n_tensors`` [B, H, T, D] tensors moved, or ``nbytes``) and ``library_ms`` (SDPA's time on the
    same inputs, from :func:`wide_sdpa`). Prints the line with the plan
    the kernel was launched with (``flash_attention.wide_plan``); no
    limit is set. Returns the kernel's ms."""
    from mmlspark_torch.dl.flash_attention import wide_plan
    B, H, T, D = x[0].shape
    ms = time_ms(run, torch, runs=10, flush=flush)
    plain_ms = time_ms(plain, torch, runs=3, warmup=1, flush=flush)
    ops = ops_per_d * D
    if nbytes is None:
        nbytes = n_tensors * B * H * T * D * x[0].element_size()
    kernel = "dkv" if "K2e" in kid else "dq" if "K2d" in kid else "fwd"
    plan = wide_plan(D, x[0].dtype, kernel)
    peak, rate = wide_peak(torch, x[0].dtype)
    bound_ms, by = bound(ops, nbytes, bw, peak)
    split = (f"{plan.ctas}-CTA clusters, {plan.units} units of {plan.unit}"
             if plan.ctas else f"{plan.units} chunks of {plan.unit}")
    print(f"{phase}: wide {kid} {str(x[0].dtype)[6:]} [{B}, {H}, {T}, {D}] "
          f"({split}): {ms:.4f} ms; plain {plain_ms:.4f} "
          f"ms; bound {bound_ms:.4f} ms by {by} ({ops / 1e9:.1f} GFLOP at "
          f"{rate}); scaled_dot_product_attention "
          f"{library_ms:.4f} ms; median of CUDA-event runs, L2 flushed")
    return ms


def wide_fault(torch, k2, x, mask):
    """The wide forward's planted fault: K2a with one CTA's share of S
    left out of the cluster's sum (rank ctas // 2: its columns of q
    zeroed, what every other CTA sums without the share it reads from
    that CTA) must fall outside phase 5's hold of the plain version.
    Fails the run if it does not."""
    from mmlspark_torch.dl.flash_attention import wide_plan
    q, k, v = x
    plan = wide_plan(q.shape[-1], q.dtype)
    if plan.ctas < 3:
        fail(f"phase 5: the planted fault needs a cluster of more than two "
             f"CTAs, D={q.shape[-1]} has {plan.ctas}")
    rank = plan.ctas // 2
    faulty_q = q.clone()
    faulty_q[..., 2 * rank * plan.unit:2 * (rank + 1) * plan.unit] = 0
    got = k2.flash_cuda(faulty_q, k, v, mask).float()
    want = k2.flash_torch(q, k, v, mask).float()
    bf16 = q.dtype == torch.bfloat16
    rtol = FLASH_BF16_RTOL if bf16 else 0.0
    atol = FLASH_BF16_ATOL if bf16 else FLASH_F32_ATOL
    torch.cuda.synchronize()
    out = int(((got - want).abs() > atol + rtol * want.abs()).sum())
    name = f"{str(q.dtype)[6:]} D={q.shape[-1]} ({plan.ctas}-CTA clusters)"
    if out == 0:
        fail(f"phase 5: wide K2a {name} with CTA {rank}'s share of S left "
             "out passes the hold: it cannot tell a faulty cluster sum")
    print(f"phase 5: planted fault (wide K2a {name}, CTA {rank}'s share of "
          f"S left out): {out} of {got.numel()} elements outside the hold, "
          "as it must")


def compare_grads(phase, name, got, dense, verbose, against="dense"):
    """Hold one step's (loss, {parameter: gradient}) ``got`` against
    ``dense``'s (a reference step, named by ``against``): per-parameter
    ||dg||/||g|| and cosine, and |dloss|, within GRAD_REL_MAX, GRAD_COS_MIN
    and LOSS_ABS_MAX. Prints the worst of each (with ``verbose`` every
    parameter's) and returns whether they pass."""
    (loss, grads), (loss_d, grads_d) = got, dense
    worst_rel, worst_cos = 0.0, 1.0
    for n, gd in grads_d.items():
        g = grads[n]
        rel = float((g - gd).norm() / gd.norm().clamp_min(1e-30))
        cos = float((g * gd).sum() / (g.norm() * gd.norm()).clamp_min(1e-30))
        worst_rel, worst_cos = max(worst_rel, rel), min(worst_cos, cos)
        if verbose:
            print(f"  {n:28s} |g| {float(gd.norm()):.4e} rel "
                  f"{rel:.3e} cos {cos:.7f}")
    dl = abs(loss - loss_d)
    ok = (worst_rel <= GRAD_REL_MAX and worst_cos >= GRAD_COS_MIN
          and dl <= LOSS_ABS_MAX)
    print(f"{phase}: {name} vs {against}: loss {loss:.6f} vs {loss_d:.6f} "
          f"(|diff| {dl:.3g}, limit {LOSS_ABS_MAX}); over "
          f"{len(grads_d)} parameter tensors worst ||dg||/||g|| "
          f"{worst_rel:.3e} (limit {GRAD_REL_MAX}), worst cosine "
          f"{worst_cos:.7f} (floor {GRAD_COS_MIN}): "
          f"{'within' if ok else 'outside'} the limits")
    return ok


def check_lse_forward(torch, k2, name, q, k, v, mask, q_off=None, k_off=0,
                      tiles=None):
    """Hold K2b (``flash_lse_cuda``, at ``tiles``, its ``block_k``/
    ``stages``, if given), or with ``q_off`` given K2c-lse at the offsets
    ``(q_off, k_off)``, against ``flash_lse_torch``: o at the forward's
    tolerance, the lse within LSE_ATOL. Rows with no allowed key must have
    o exactly 0 and lse exactly -1e30. Returns o, the lse, the rows with
    no allowed key and the largest |difference| over o and lse."""
    bf16 = q.dtype == torch.bfloat16
    causal = q_off is not None
    pos = dict(causal=causal, q_offset=q_off or 0, k_offset=k_off)
    fwd = KERNEL_IDS[causal][0]
    B, _, T, _ = q.shape
    o, lse = k2.flash_lse_cuda(q, k, v, mask, **pos, **(tiles or {}))
    want_o, want_lse = k2.flash_lse_torch(q, k, v, mask, **pos)
    keys = (torch.ones(B, T, dtype=torch.bool, device=q.device)
            if mask is None else mask)
    if causal:
        empty = causal_empty_rows(torch, keys, B, T, q_off, k_off, q.device)
    else:
        empty = (~keys.any(1, keepdim=True)).expand(B, T)
    if not causal and bool(empty.all()):   # (causal offsets may, on purpose)
        fail(f"{fwd} {name}: no row has an allowed key; the hold would "
             "compare zeros with zeros")
    lse_r, want_r = lse.transpose(1, 2), want_lse.transpose(1, 2)
    err_f = max(hold(torch, f"{fwd} o {name}", o, want_o,
                     FLASH_BF16_RTOL if bf16 else 0.0,
                     FLASH_BF16_ATOL if bf16 else FLASH_F32_ATOL),
                hold(torch, f"{fwd} lse {name}", lse_r[~empty],
                     want_r[~empty], 0.0, LSE_ATOL))
    if not ((o.transpose(1, 2)[empty] == 0).all()
            and (lse_r[empty] == -1e30).all()):
        fail(f"{fwd} {name}: a row with no allowed key has o not exactly 0 "
             "or lse not -1e30")
    return o, lse, empty, err_f


def check_training_kernels(torch, k2, name, q, k, v, dout, mask,
                           dlse=None, q_off=None, k_off=0):
    """Hold K2b, K2d and K2e against their plain versions on one input, or
    with ``q_off`` given their causal branches (K2c-lse, causal K2d and K2e)
    at the offsets ``(q_off, k_off)``. Rows with no allowed key must have o
    and dq exactly 0 and lse exactly -1e30; keys no row may see (invalid,
    or when causal after every row's position) dk and dv exactly 0.
    Returns the largest |difference| of each kernel (the forward's over o
    and lse)."""
    bf16 = q.dtype == torch.bfloat16
    causal = q_off is not None
    pos = dict(causal=causal, q_offset=q_off or 0, k_offset=k_off)
    fwd, kd, ke = KERNEL_IDS[causal]
    T = q.shape[2]
    o, lse, empty, err_f = check_lse_forward(torch, k2, name, q, k, v, mask,
                                             q_off, k_off)
    if causal:
        unseen = ~mask | (k_off + torch.arange(T, device=q.device)
                          > q_off + T - 1)[None, :]
    else:
        unseen = ~mask
    # the backward from the kernel's own o and lse, as training runs it
    dsum = k2.flash_dsum(o, dout, dlse)
    rtol, of_max = ((BWD_BF16_RTOL, BWD_BF16_ATOL_OF_MAX) if bf16
                    else (BWD_F32_RTOL, BWD_F32_ATOL_OF_MAX))
    args = (q, k, v, mask, dout, lse, dsum)
    dq = k2.flash_dq_cuda(*args, **pos)
    dk, dv = k2.flash_dkv_cuda(*args, **pos)
    want_dq = k2.flash_dq_torch(*args, **pos)
    want_dk, want_dv = k2.flash_dkv_torch(*args, **pos)
    err_d = hold_grad(torch, f"{kd} dq {name}", dq, want_dq, rtol, of_max)
    err_e = max(hold_grad(torch, f"{ke} dk {name}", dk, want_dk, rtol,
                          of_max),
                hold_grad(torch, f"{ke} dv {name}", dv, want_dv, rtol,
                          of_max))
    if not (dq.transpose(1, 2)[empty] == 0).all():
        fail(f"{kd} {name}: a row with no allowed key has dq not exactly 0")
    if not ((dk.transpose(1, 2)[unseen] == 0).all()
            and (dv.transpose(1, 2)[unseen] == 0).all()):
        fail(f"{ke} {name}: a key no row may see has dk/dv not exactly 0")
    print(f"{fwd}/{kd}/{ke} {name}: max |diff| o/lse {err_f:.3g}, dq "
          f"{err_d:.3g}, dk/dv {err_e:.3g}; {int(empty.sum())} (b, row) "
          f"with no allowed key and {int(unseen.sum())} (b, key) no row may "
          "see exactly 0")
    return err_f, err_d, err_e


# the forward with the lse and the two backward kernels, non-causal and
# causal: the ids printed, and the names and TPU kernel lines of their
# records
KERNEL_IDS = {False: ("K2b", "K2d", "K2e"),
              True: ("K2c-lse", "causal K2d", "causal K2e")}
KERNEL_RECORDS = {
    False: (("flash_lse", "flash_attn.cu", 126),
            ("flash_bwd_dq", "flash_bwd.cu", 350),
            ("flash_bwd_dkv", "flash_bwd.cu", 388)),
    True: (("flash_lse_causal", "flash_attn.cu", 142),
           ("flash_bwd_dq_causal", "flash_bwd.cu", 350),
           ("flash_bwd_dkv_causal", "flash_bwd.cu", 388))}


def sdpa_times(torch, q, k, v, dout, flush, **kw):
    """``scaled_dot_product_attention``'s forward alone and its backward
    (forward + backward through autograd less the forward), in ms: the
    library yardstick beside the forward kernel and beside K2d + K2e."""
    import torch.nn.functional as F
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    fwd = time_ms(lambda: F.scaled_dot_product_attention(*leaves, **kw),
                  torch, flush=flush)
    both = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*leaves, **kw), leaves, dout),
        torch, flush=flush)
    return fwd, both - fwd


def training_kernel_records(torch, k2, phase, q, k, v, mask, dout, causal,
                            pairs, library, errs, bw, flush):
    """Time the forward with the lse and K2d/K2e (``causal``: their causal
    branches at offsets (0, 0)) on one input, each beside its plain version
    and its bound for ``pairs`` allowed (query, key) pairs, and build their
    records for the kernels line (launches filled in later). ``library``:
    the library's (forward, backward) ms."""
    pos = dict(causal=causal)
    o, lse = k2.flash_lse_cuda(q, k, v, mask, **pos)
    dsum = k2.flash_dsum(o, dout)
    args = (q, k, v, mask, dout, lse, dsum)
    kernels = ((lambda: k2.flash_lse_cuda(q, k, v, mask, **pos),
                lambda: k2.flash_lse_torch(q, k, v, mask, **pos)),
               (lambda: k2.flash_dq_cuda(*args, **pos),
                lambda: k2.flash_dq_torch(*args, **pos)),
               (lambda: k2.flash_dkv_cuda(*args, **pos),
                lambda: k2.flash_dkv_torch(*args, **pos)))
    B, H, T, D = q.shape
    tensor = B * H * T * D * 2                   # one bf16 [B, H, T, D]
    rows = B * H * T * 4                         # one f32 [B, H, T]
    work = ((4 * pairs * D, 4 * tensor + rows + B * T),
            (6 * pairs * D, 5 * tensor + 2 * rows + B * T),
            (8 * pairs * D, 6 * tensor + 2 * rows + B * T))
    records = []
    for kid, (fn, src, line), (run, plain), (ops, nbytes), err, lib in zip(
            KERNEL_IDS[causal], KERNEL_RECORDS[causal], kernels, work, errs,
            (library[0], library[1], library[1])):
        ms = time_ms(run, torch, flush=flush)
        plain_ms = time_ms(plain, torch, runs=5, flush=flush)
        bound_ms, by = bound(ops, nbytes, bw)
        print(f"{phase}: {kid} {ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
              f"{bound_ms:.4f} ms by {by} ({ops / 1e9:.1f} GFLOP over "
              f"{pairs} allowed pairs at 989 TFLOP/s; {nbytes / 1e6:.1f} "
              "MB); median of CUDA-event runs, L2 flushed")
        records.append({
            "name": fn, "route": "cuda",
            "source": f"mmlspark_torch/dl/csrc/{src}",
            "replaces": f"mmlspark_tpu/dl/pallas_attention.py:{line}",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": lib})
    return records


def wide_training_times(torch, k2, phase, dev, gen, bw, flush, causal):
    """Time the wide instances of the forward with the lse and of K2d and
    K2e (causal branches with ``causal``) at WIDE_TIMED."""
    pos = dict(causal=causal)
    for x, mask in wide_inputs(torch, gen, dev, 4):
        pairs = wide_pairs(mask, x[0].shape[1], causal)
        o, lse = k2.flash_lse_cuda(*x[:3], mask, **pos)
        args = (*x[:3], mask, x[3], lse, k2.flash_dsum(o, x[3]))
        fwd, kd, ke = KERNEL_IDS[causal]
        lib_f, lib_b = wide_sdpa(torch, x, mask, causal, x[3], flush)
        time_wide(torch, phase, fwd, x,
                  lambda: k2.flash_lse_cuda(*x[:3], mask, **pos),
                  lambda: k2.flash_lse_torch(*x[:3], mask, **pos),
                  4 * pairs, 4, bw, flush, lib_f)
        time_wide(torch, phase, kd, x,
                  lambda: k2.flash_dq_cuda(*args, **pos),
                  lambda: k2.flash_dq_torch(*args, **pos),
                  6 * pairs, 5, bw, flush, lib_b)
        time_wide(torch, phase, ke, x,
                  lambda: k2.flash_dkv_cuda(*args, **pos),
                  lambda: k2.flash_dkv_torch(*args, **pos),
                  8 * pairs, 6, bw, flush, lib_b)


def deterministic(torch, k2, phase, q, k, v, dout, mask, causal):
    """K2d and K2e own their output rows (no atomics): two launches on the
    same inputs must give the same bits."""
    pos = dict(causal=causal)
    o, lse = k2.flash_lse_cuda(q, k, v, mask, **pos)
    args = (q, k, v, mask, dout, lse, k2.flash_dsum(o, dout))
    runs = [(k2.flash_dq_cuda(*args, **pos), *k2.flash_dkv_cuda(*args, **pos))
            for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        fail(f"{phase}: two launches of K2d/K2e on the same inputs differ")
    print(f"{phase}: {KERNEL_IDS[causal][1]}/{KERNEL_IDS[causal][2]} "
          "deterministic: two launches bit-equal in dq, dk and dv")


def train_kernel_phase(torch, k2, dev, bw, flush, lengths, B):
    """Phase 7: K2b, K2d and K2e against their plain versions at the
    training path's attention shape and beside, then their times. Returns
    the kernels' records (launches filled in by phase 8)."""
    T, H, W = TEXT_T, TEXT_SHAPE["heads"], TEXT_SHAPE["width"]
    D = W // H
    mask_np = np.arange(T)[None, :] < lengths[:B, None]
    mask_np[-1] = False                           # one fully masked row
    mask = torch.from_numpy(mask_np).to(dev)
    gen = torch.Generator(device=dev).manual_seed(31)
    qkv = torch.randn(B, T, 3 * W, generator=gen, device=dev,
                      dtype=torch.bfloat16)
    q, k, v = (a.view(B, T, H, D).transpose(1, 2)
               for a in qkv.split(W, dim=-1))
    # the incoming gradient as the head merge's backward hands it over
    dout = torch.randn(B, T, H, D, generator=gen, device=dev,
                       dtype=torch.bfloat16).transpose(1, 2)
    dlse = torch.randn(B, H, T, generator=gen, device=dev)
    shape = f"B={B} H={H} T={T} D={D}"
    errs = check_training_kernels(torch, k2, f"bf16 {shape}", q, k, v, dout,
                                  mask)
    errs_lse = check_training_kernels(torch, k2, f"bf16 {shape} with dlse",
                                      q, k, v, dout, mask, dlse)
    errs = [max(a, b) for a, b in zip(errs, errs_lse)]
    Tf = 2000
    xf = [torch.randn(B, H, Tf, D, generator=gen, device=dev)
          for _ in range(4)]
    mask_f = mask[:, :Tf].clone()
    mask_f[0] = False
    check_training_kernels(torch, k2, f"f32 ragged B={B} H={H} T={Tf} "
                           f"D={D}", *xf, mask_f, dlse[:, :, :Tf])
    del xf
    for d in HEAD_DIMS_HELD[1:]:   # 96, 192, 320: padded to 128, 256, 384
        for dtype in (torch.bfloat16, torch.float32):
            x = [torch.randn(2, 4, 300, d, generator=gen, device=dev,
                             dtype=dtype) for _ in range(4)]
            name = f"{str(dtype)[6:]} B=2 H=4 T=300 D={d}"
            check_training_kernels(
                torch, k2, name, *x,
                mask_f[:2, :300], torch.randn(2, 4, 300, generator=gen,
                                              device=dev))
            if d in (256, 512) and (d == 512) == (dtype == torch.bfloat16):
                deterministic(torch, k2, f"phase 7 ({name}, wide)", *x[:3],
                              x[3], mask_f[:2, :300], False)
    mask_h = wide_hold_mask(torch, dev)
    for d, dtype, label in wide_held(torch):  # wider clusters, then split
        x = [torch.randn(2, 2, 200, d, generator=gen, device=dev,
                         dtype=dtype) for _ in range(4)]
        name = f"{str(dtype)[6:]} B=2 H=2 T=200 D={d} ({label})"
        check_training_kernels(
            torch, k2, name, *x, mask_h,
            torch.randn(2, 2, 200, generator=gen, device=dev))
        if d == 2048:                  # K2e in clusters of 16 CTAs
            deterministic(torch, k2, f"phase 7 ({name})", *x[:3], x[3],
                          mask_h, False)
    deterministic(torch, k2, "phase 7", q, k, v, dout, mask, False)
    wide_training_times(torch, k2, "phase 7", dev, gen, bw, flush, False)

    # the library yardstick: SDPA with the bool mask (its backward computes
    # dq, dk and dv together, so it stands beside K2d + K2e)
    sdpa = sdpa_times(torch, q, k, v, dout, flush,
                      attn_mask=mask[:, None, None, :])
    # the work this mask needs: every query row against the valid keys of
    # its document (P pairs per head); key tiles with no valid key are
    # skipped
    pairs = H * T * int(mask.sum())
    records = training_kernel_records(torch, k2, "phase 7", q, k, v, mask,
                                      dout, False, pairs, sdpa, errs, bw,
                                      flush)
    print(f"phase 7: scaled_dot_product_attention forward {sdpa[0]:.4f} ms "
          f"(beside K2b), backward {sdpa[1]:.4f} ms (forward + backward "
          "minus the forward; beside K2d + K2e "
          f"{records[1]['ms'] + records[2]['ms']:.4f} ms)")
    return records


def train_phases(torch, k1, k2, dev, bw, flush, texts, lengths, args):
    """Phases 7 and 8: the training kernels against their plain versions,
    then masked-LM pretraining at full width. Returns the K2b, K2d and K2e
    records for the kernels line."""
    import copy

    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.dl import (MaskedLMModel, TextEncoder,
                                   TextEncoderFeaturizer, encoder_variables,
                                   make_attention_fn, mask_batch,
                                   masked_xent, pretrain_masked_lm)
    from mmlspark_torch.featurize import TokenIdEncoder
    from mmlspark_torch.models import LoadedModel, get_model

    B, S = args.batch, args.train_steps
    records = train_kernel_phase(torch, k2, dev, bw, flush, lengths, B)

    # ---- phase 8: documents -> ids -> pretrain_masked_lm at full width
    vocab = TEXT_SHAPE["vocab"]
    ids = np.asarray(TokenIdEncoder(maxLength=TEXT_T, vocabSize=vocab - 1)
                     .transform(DataFrame({"text": texts}))["tokens"])
    if ids.max() >= vocab - 1:
        fail(f"token id {ids.max()} collides with the mask id {vocab - 1}")

    def new_model():
        gen = torch.Generator().manual_seed(0)
        return MaskedLMModel(TextEncoder(
            **TEXT_SHAPE, attention_fn=make_attention_fn("pallas"),
            generator=gen), gen)

    counters = {"K2a": k2.flash_cuda, "K2b": k2.flash_lse_cuda,
                "K2d": k2.flash_dq_cuda, "K2e": k2.flash_dkv_cuda,
                "K1": k1.hist_cuda}
    model = new_model()
    pretrain_masked_lm(model, ids, steps=1, batch_size=B, seed=100)  # warm
    torch.cuda.synchronize()
    windows, counts, losses = [], [], []
    for run in range(TRAIN_RUNS):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        state, run_losses = pretrain_masked_lm(model, ids, steps=S,
                                               batch_size=B, seed=run)
        torch.cuda.synchronize()
        windows.append(time.perf_counter() - t0)
        counts.append({name: fn.launches for name, fn in counters.items()})
        losses += run_losses
    depth = TEXT_SHAPE["depth"]
    want = {"K2a": 0, "K2b": depth * S, "K2d": depth * S, "K2e": depth * S,
            "K1": 0}
    if any(c != want for c in counts):
        fail(f"launches per window of {S} steps {counts}: expected {want}, "
             "one K2b, K2d and K2e launch per block per step and no K2a")
    if not np.isfinite(losses).all():
        fail(f"non-finite pretraining losses {losses}")
    step_s = float(np.median(windows)) / S
    # the same batches on the host: what mask_batch costs, and the tokens
    tokens, t_mask = [], 0.0
    for run in range(TRAIN_RUNS):              # the timed windows' seeds
        rng = np.random.default_rng(run)
        for _ in range(S):
            t0 = time.perf_counter()
            rows = ids[rng.integers(0, len(ids), size=B)]
            x, y = mask_batch(rows, rng, mask_id=vocab - 1)
            t_mask += time.perf_counter() - t0
            tokens.append(int((rows != 0).sum()))
    t0 = time.perf_counter()
    for _ in range(S):
        xd = torch.from_numpy(x).pin_memory().to(dev, non_blocking=True)
        yd = torch.from_numpy(y).pin_memory().to(dev, non_blocking=True)
    torch.cuda.synchronize()
    t_copy = (time.perf_counter() - t0) / S
    print(f"phase 8: pretrain_masked_lm, batch {B} x T={TEXT_T}, "
          f"{TEXT_SHAPE}, AdamW: step {step_s:.4f} s, median over "
          f"{TRAIN_RUNS} windows of {S} steps "
          f"({', '.join(f'{w:.4f}' for w in windows)} "
          f"s): {B / step_s:.2f} seqs/s, {np.mean(tokens) / step_s:,.0f} "
          f"non-pad tokens/s; launches per step K2b {counts[-1]['K2b'] // S}, "
          f"K2d {counts[-1]['K2d'] // S}, K2e {counts[-1]['K2e'] // S}, K2a "
          f"{counts[-1]['K2a']}; losses {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"phase 8: host per step: row draw and mask_batch "
          f"{t_mask / len(tokens) * 1e3:.3f} ms; batch copy (pinned, "
          f"non_blocking, then a synchronize) "
          f"{t_copy * 1e3:.3f} ms")
    for r, kid in zip(records, KERNEL_IDS[False]):
        r["launches"] = counts[-1][kid] // S
    OBS.update(masked_lm=model, masked_lm_ids=ids)

    # one step's loss and gradients through the kernels against autograd
    # through dense attention, on the same weights and batch
    base = new_model()
    rng = np.random.default_rng(0)
    rows = ids[rng.integers(0, len(ids), size=B)]
    x, y = (torch.from_numpy(a).to(dev)
            for a in mask_batch(rows, rng, mask_id=vocab - 1))

    def loss_and_grads(impl):
        m = copy.deepcopy(base)
        m.encoder = m.encoder.with_attention(make_attention_fn(impl))
        m.to(dev)
        loss = masked_xent(m(x, train=True)["logits"], y)
        loss.backward()
        grads = {n: p.grad.float() for n, p in m.named_parameters()}
        return float(loss.detach()), grads

    loss_k, grads_k = loss_and_grads("pallas")
    dense = loss_and_grads("dense")

    def compare(name, loss, grads, verbose):
        return compare_grads("phase 8", name, (loss, grads), dense, verbose)

    print("phase 8: per-parameter gradients, kernels (pallas) vs dense:")
    if not compare("pallas", loss_k, grads_k, True):
        fail("gradients through the kernels and through dense attention "
             "disagree beyond the limits")
    del grads_k
    def zero_dsum(real):
        def planted(*a, **kw):            # dsum is the last argument
            return real(*a[:-1], torch.zeros_like(a[-1]), **kw)
        planted.launches = 0              # the real wrapper counts here
        return planted

    real_dq, real_dkv = k2.flash_dq_cuda, k2.flash_dkv_cuda
    k2.flash_dq_cuda, k2.flash_dkv_cuda = zero_dsum(real_dq), \
        zero_dsum(real_dkv)
    try:
        loss_f, grads_f = loss_and_grads("pallas")
    finally:
        k2.flash_dq_cuda, k2.flash_dkv_cuda = real_dq, real_dkv
    if compare("planted fault (dsum zeroed in K2d/K2e)", loss_f, grads_f,
               False):
        fail("the gradient limits pass K2d/K2e with dsum zeroed: they "
             "cannot tell a faulty backward")
    del grads_f, dense, base

    # the trained trunk serves the embedding path (K2a)
    trunk = encoder_variables(state)
    loaded = LoadedModel(get_model("TextEncoderLong"), trunk)
    kw = dict(vocabSize=vocab, width=TEXT_SHAPE["width"],
              depth=depth, heads=TEXT_SHAPE["heads"], model=loaded)
    df = DataFrame({"tokens": ids})
    k2.flash_cuda.launches = 0
    pooled = TextEncoderFeaturizer(attentionImpl="pallas", inputCol="tokens",
                                   **kw).transform(df)["features"]
    if k2.flash_cuda.launches != depth:
        fail(f"the trained trunk's transform launched K2a "
             f"{k2.flash_cuda.launches} times, expected {depth}")
    dense = TextEncoderFeaturizer(attentionImpl="dense", inputCol="tokens",
                                  **kw).transform(df)["features"]
    if not np.isfinite(pooled).all():
        fail("the trained trunk's pooled embeddings are not finite")
    hold_pooled(torch, k2, dev, "phase 8: trained trunk", trunk, ids, pooled,
                dense, TRUNK_POOLED_LIMITS)
    return records


def gbdt_phases(torch, k1, dev, bw, flush, args):
    """Phases 2-4: K1 against its plain version, the GBDT main path through
    K1, and the same fit with the plain histogram. Returns K1's record for
    the kernels line."""
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.lightgbm import LightGBMClassifier
    from mmlspark_torch.lightgbm.binning import (bin_features,
                                                 compute_bin_boundaries)
    from mmlspark_torch.train import ComputeModelStatistics

    n, F, B, iters = args.rows, 28, 256, args.iterations
    feats, labels = higgs_like(n)

    # ---- phase 2: K1 against the plain version at the main path's shapes
    bounds = compute_bin_boundaries(feats, 255)
    bins = bin_features(torch.from_numpy(feats).to(dev),
                        torch.from_numpy(bounds))
    y = torch.from_numpy(labels).to(dev)
    p0 = float(labels.mean())
    g = torch.full((n,), p0, device=dev) - y      # grad at the average init
    h = torch.full((n,), p0 * (1 - p0), device=dev)
    root_vals = torch.stack([g, h, torch.ones(n, device=dev)], 1)
    sel_np = np.random.default_rng(11).random(n) < 0.3
    sel = torch.from_numpy(sel_np.astype(np.float32)).to(dev)
    masked_vals = root_vals * sel[:, None]
    count = (2 * n) // 3
    padded_vals = root_vals.clone()
    padded_vals[count:] = 0.0                     # rows past count: padding
    count_dev = torch.tensor(count, dtype=torch.int32, device=dev)
    max_err = max(
        check_hist(torch, k1, "root", bins, root_vals, B),
        check_hist(torch, k1, "masked 30%", bins, masked_vals, B),
        check_hist(torch, k1, f"count={count}", bins, padded_vals, B,
                   count=count_dev),
        check_hist(torch, k1, "root, int32 bins", bins.to(torch.int32),
                   root_vals, B))

    ms = time_ms(lambda: k1.hist_cuda(bins, root_vals, num_bins=B),
                 torch, flush=flush)
    ms_masked = time_ms(lambda: k1.hist_cuda(bins, masked_vals,
                                               num_bins=B),
                        torch, flush=flush)
    plain_ms = time_ms(lambda: k1.hist_torch(bins, root_vals, num_bins=B),
                       torch, flush=flush)
    keys = (bins.to(torch.int64)
            + torch.arange(F, device=dev, dtype=torch.int64)[None, :] * B
            ).reshape(-1)
    src = root_vals[:, None, :].expand(n, F, 3).reshape(n * F, 3)
    acc = torch.zeros(F * B, 3, device=dev)
    library_ms = time_ms(lambda: acc.index_add_(0, keys, src), torch,
                         flush=flush)
    del keys, src, acc
    bytes_moved = n * F * 1 + n * 12 + F * B * 12
    ops = 3 * n * F
    bound_bytes_ms = bytes_moved / bw * 1e3
    bound_ops_ms = ops / F32_PEAK_FLOPS * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    bound_by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
    print(f"phase 2: K1 root {ms:.4f} ms, masked 30% {ms_masked:.4f} ms; "
          f"plain {plain_ms:.4f} ms; index_add_ alone {library_ms:.4f} ms; "
          f"bound {bound_ms:.4f} ms by {bound_by} "
          f"({bytes_moved / 1e6:.2f} MB, {ops / 1e6:.1f} M adds); "
          f"median of 25 CUDA-event runs, L2 flushed")

    # ---- phase 3: fit → transform → AUC through K1
    df = DataFrame({"features": feats, "label": labels})
    kw = dict(numIterations=iters, numLeaves=31, maxBin=255,
              learningRate=0.1)
    t0 = time.perf_counter()
    compute_bin_boundaries(feats, 255)
    host_binning_s = time.perf_counter() - t0
    LightGBMClassifier(**kw).fit(df)              # warm-up fit
    torch.cuda.synchronize()
    fit_times, fit_launches = [], []
    for _ in range(FIT_RUNS):
        k1.hist_cuda.launches = 0
        t0 = time.perf_counter()
        model = LightGBMClassifier(**kw).fit(df)
        torch.cuda.synchronize()
        fit_times.append(time.perf_counter() - t0)
        fit_launches.append(k1.hist_cuda.launches)
    fit_s = float(np.median(fit_times))
    launches = fit_launches[-1]
    if launches == 0 or len(set(fit_launches)) != 1:
        fail(f"K1 launches per fit {fit_launches}: expected the same "
             "nonzero count in every fit")
    # K1's device time over one fit (both of its kernels), from the trace
    fit_k1 = device_ms(torch, lambda: LightGBMClassifier(**kw).fit(df),
                       ("hist_partial", "hist_reduce"), runs=1)
    fit_k1_ms = fit_k1["hist_partial"] + fit_k1["hist_reduce"]
    print(f"phase 3: K1 device time over one fit (torch.profiler) "
          f"{fit_k1_ms:.3f} ms ({fit_k1['hist_partial']:.3f} partial "
          f"histograms + {fit_k1['hist_reduce']:.3f} reductions) in "
          f"{launches} calls, {fit_k1_ms / launches:.4f} ms a call; the root "
          f"scan's time x {launches} would be {ms * launches:.3f} ms")
    model.transform(df)                           # warm-up transform
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scored = model.transform(df)
    transform_s = time.perf_counter() - t0
    prob = np.asarray(scored["probability"])
    if prob.shape != (n, 2) or not np.isfinite(prob).all():
        fail(f"transform gave probabilities of shape {prob.shape} with "
             f"{(~np.isfinite(prob)).sum()} non-finite values")
    auc = float(ComputeModelStatistics(labelCol="label")
                .transform(scored)["AUC"][0])
    if not 0.75 < auc <= 1.0:
        fail(f"AUC {auc} outside (0.75, 1]")
    small = feats[:2000]
    gpu_raw = model.booster.raw_scores(small, device="cuda")
    cpu_raw = model.booster.raw_scores(small, device="cpu")
    if not np.allclose(gpu_raw, cpu_raw, rtol=0, atol=1e-5):
        fail("scoring on the card and on the CPU disagree beyond 1e-5")
    OBS.update(gbdt_df=df, gbdt_kw=kw, gbdt_model=model,
               gbdt_launches=launches)
    print(f"phase 3: fit {fit_s:.3f} s warm, median of {FIT_RUNS} "
          f"({', '.join(f'{t:.3f}' for t in fit_times)} s; "
          f"{n * iters / fit_s:,.0f} "
          f"rows*iterations/s; host bin boundaries {host_binning_s:.3f} s of "
          f"it), transform {transform_s:.3f} s ({n / transform_s:,.0f} "
          f"rows/s), AUC {auc:.6f}, K1 launches per fit {launches}")

    # ---- phase 4: the same fit with the plain histogram on the card
    plain_clf = LightGBMClassifier(**kw)
    plain_clf._hist_impl = "torch"
    k1.hist_cuda.launches = 0
    t0 = time.perf_counter()
    plain_model = plain_clf.fit(df)
    torch.cuda.synchronize()
    plain_fit_s = time.perf_counter() - t0
    if k1.hist_cuda.launches != 0:
        fail("the plain-histogram fit launched K1")
    plain_auc = float(ComputeModelStatistics(labelCol="label").transform(
        plain_model.transform(df))["AUC"][0])
    a, b = model.booster.arrays, plain_model.booster.arrays
    root = (int(a["feature"][0, 0]), float(a["threshold"][0, 0]))
    plain_root = (int(b["feature"][0, 0]), float(b["threshold"][0, 0]))
    internal = ~a["is_leaf"][0] & (a["left"][0] >= 0)
    agree = int((internal & (a["feature"][0] == b["feature"][0])
                 & (a["threshold"][0] == b["threshold"][0])).sum())
    print(f"phase 4: plain-histogram fit {plain_fit_s:.3f} s, AUC "
          f"{plain_auc:.6f} (|diff| {abs(plain_auc - auc):.2e}); tree 0 "
          f"root (feature, threshold) {root} vs {plain_root}; "
          f"{agree} of {int(internal.sum())} tree-0 splits agree")
    if abs(plain_auc - auc) > 1e-3:
        fail(f"kernel fit AUC {auc} and plain fit AUC {plain_auc} differ "
             "by more than 1e-3")
    if root != plain_root:
        fail(f"tree 0 root split differs: {root} vs {plain_root}")

    return {"name": "hist", "route": "cuda",
            "source": "mmlspark_torch/lightgbm/csrc/hist.cu",
            "replaces": "mmlspark_tpu/lightgbm/pallas_hist.py:45",
            "launches": launches, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "masked_ms": ms_masked, "fit_device_ms": fit_k1_ms}


# ---------------------------------------------------------------- LLM slice

def causal_empty_rows(torch, mask, B, T, q_off, k_off, dev):
    """[B, T] bool: the query rows of a causal call with no allowed key
    (their output must be exactly 0)."""
    if mask is None:
        first = torch.zeros(B, dtype=torch.long, device=dev)
        none_valid = torch.zeros(B, 1, dtype=torch.bool, device=dev)
    else:
        first = mask.long().argmax(1)
        none_valid = ~mask.any(1, keepdim=True)
    r = torch.arange(T, device=dev)
    return none_valid | ((k_off + first[:, None]) > (q_off + r[None, :]))


def fused_qkv(torch, gen, dev, B, T, H, D, dtype):
    """q, k, v [B, H, T, D] as views of one fused projection, the
    encoder's layout."""
    qkv = torch.randn(B, T, 3 * H * D, generator=gen, device=dev,
                      dtype=dtype)
    return tuple(a.view(B, T, H, D).transpose(1, 2)
                 for a in qkv.split(H * D, dim=-1))


def check_causal(torch, k2, name, q, k, v, mask, q_off=0, k_off=0,
                 tiles=None):
    """Hold K2c (at ``tiles``, if given) against the causal plain version
    on one input; rows with no allowed key must be exactly 0. Returns the
    largest |difference|."""
    bf16 = q.dtype == torch.bfloat16
    want = k2.flash_torch(q, k, v, mask, causal=True, q_offset=q_off,
                          k_offset=k_off)
    got = k2.flash_causal_cuda(q, k, v, mask, q_offset=q_off,
                               k_offset=k_off, **(tiles or {}))
    err = hold(torch, f"K2c {name}", got, want,
               FLASH_BF16_RTOL if bf16 else 0.0,
               FLASH_BF16_ATOL if bf16 else FLASH_F32_ATOL)
    B, _, T, _ = q.shape
    empty = causal_empty_rows(torch, mask, B, T, q_off, k_off, q.device)
    if not (got.transpose(1, 2)[empty] == 0).all():
        fail(f"K2c {name}: a row with no allowed key is not exactly 0")
    print(f"K2c {name}: max |diff| {err:.3g}; {int(empty.sum())} (b, row) "
          "pairs with no allowed key exactly 0")
    return err


def paged_case(torch, dev, seed, S, w, BL, MB, H, hd, dtype, full=False):
    """A seeded K3 input: context lengths in [w, MB*BL] (all MB*BL with
    ``full``), each slot's chain of distinct block ids shuffled across the
    pool and padded with TRASH_BLOCK to MB, the last slot inactive (an
    all-trash row) unless S == 1; the window sits at the end of each
    context (pos = ctx - w). The pools, trash block included, are random;
    at a head dim the kernel is not built for they are zero-padded to the
    next one, as the engine allocates them."""
    rng = np.random.default_rng(seed)
    cap = MB * BL
    ctx = np.full(S, cap) if full else rng.integers(w, cap + 1, size=S)
    nblk = -(-ctx // BL)
    active = np.ones(S, bool)
    if S > 1:
        active[-1] = False
        nblk[-1] = 0
    NB = 1 + int(nblk.sum())
    ids = rng.permutation(np.arange(1, NB))
    rows = np.zeros((S, MB), np.int32)
    at = 0
    for s in range(S):
        rows[s, :nblk[s]] = ids[at:at + nblk[s]]
        at += nblk[s]
    pos = (ctx - w).astype(np.int32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    from mmlspark_torch.dl.flash_attention import (kernel_head_dim,
                                                   pad_head_dim)
    pools = [pad_head_dim(torch.randn(NB, BL, H, hd, generator=gen,
                                      device=dev, dtype=dtype),
                          kernel_head_dim(hd)) for _ in range(2)]
    qkv = torch.randn(S, w, 3 * H * hd, generator=gen, device=dev,
                      dtype=dtype)
    q = qkv[..., :H * hd].view(S, w, H, hd).transpose(1, 2)
    return dict(q=q, k_pool=pools[0], v_pool=pools[1],
                rows=torch.from_numpy(rows).to(dev),
                pos=torch.from_numpy(pos).to(dev), active=active,
                nblk=-(-(pos + w) // BL) * active)


def check_paged(torch, k3, name, c):
    """Hold K3 against its plain version on the active slots, twice: the
    kernel ``paged_window_attention`` picks (the decode kernel up to 16
    window rows, the window kernel above), and the window kernel called
    directly, so that every instance of both meets every case; an inactive
    (all-trash) slot must be exactly 0. Returns the largest |difference|
    of each kernel, ``{"decode": err or 0.0, "window": err}``."""
    bf16 = c["q"].dtype == torch.bfloat16
    args = (c["q"], c["k_pool"], c["v_pool"], c["rows"], c["pos"])
    want = k3.paged_torch(*args)
    act = torch.from_numpy(c["active"]).to(want.device)
    picked = ("decode" if c["q"].shape[2] <= k3.DECODE_MAX_ROWS
              else "window")
    errs = {"decode": 0.0}
    for kind, run in ((picked, k3.paged_window_attention),
                      ("window", k3.paged_cuda)):
        label = f"K3 {name}" + (" (window kernel, direct)"
                                if run is k3.paged_cuda else "")
        got = run(*args)
        errs[kind] = hold(torch, label, got[act], want[act],
                          PAGED_BF16_RTOL if bf16 else 0.0,
                          PAGED_BF16_ATOL if bf16 else PAGED_F32_ATOL)
        if not (got[~act] == 0).all():
            fail(f"{label}: an all-trash slot is not exactly 0")
        print(f"{label}: max |diff| {errs[kind]:.3g}; "
              f"{int((~act).sum())} all-trash slot(s) exactly 0")
        if picked == "window":
            break                       # the switch already took paged_cuda
    return errs


def bound(ops, nbytes, bw, peak=BF16_PEAK_FLOPS):
    """(bound ms, bound_by): the larger of the operations over the peak
    and the bytes over the memory rate."""
    ops_ms, bytes_ms = ops / peak * 1e3, nbytes / bw * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def llm_kernel_phase(torch, k2, k3, dev, bw, flush, lengths):
    """Phase 9: K2c and K3 against their plain versions on the card, and
    their times. Returns the two records (launches filled in by phases 10
    and 11)."""
    import torch.nn.functional as F
    H, D = TEXT_SHAPE["heads"], TEXT_SHAPE["width"] // TEXT_SHAPE["heads"]
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(41)

    # ---- K2c at the causal shapes of bench.py:835 and :885, the generate
    # prefill, the document mask of phase 7, offsets, ragged T, head dims
    big = fused_qkv(torch, gen, dev, 2, 2048, H, D, bf16)
    errs = [check_causal(torch, k2, "bf16 [2, 8, 2048, 64]", *big, None),
            check_causal(torch, k2, "bf16 [2, 8, 2048, 64] offsets (2048, 0)",
                         *big, None, 2048, 0),
            check_causal(torch, k2, "bf16 [2, 8, 2048, 64] offsets (0, 2048)",
                         *big, None, 0, 2048)]
    long_ = fused_qkv(torch, gen, dev, 1, 8192, H, D, bf16)
    errs.append(check_causal(torch, k2, "bf16 [1, 8, 8192, 64]", *long_,
                             None))
    prefill = fused_qkv(torch, gen, dev, GEN_BATCH, GEN_T - 1, H, D, bf16)
    errs.append(check_causal(torch, k2, f"bf16 [{GEN_BATCH}, 8, "
                             f"{GEN_T - 1}, 64] (generate prefill)",
                             *prefill, None))
    B = min(TRAIN_BATCH, len(lengths))
    mask_np = np.arange(TEXT_T)[None, :] < lengths[:B, None]
    mask_np[-1] = False                           # one fully masked row
    mask = torch.from_numpy(mask_np).to(dev)
    docs = fused_qkv(torch, gen, dev, B, TEXT_T, H, D, bf16)
    errs.append(check_causal(torch, k2, f"bf16 [{B}, 8, 2048, 64] document "
                             "mask", *docs, mask))
    del docs
    Tf = 2000
    xf = fused_qkv(torch, gen, dev, B, Tf, H, D, torch.float32)
    mask_f = mask[:, :Tf].clone()
    mask_f[0] = False
    check_causal(torch, k2, f"f32 ragged [{B}, 8, {Tf}, 64] document mask",
                 *xf, mask_f)
    del xf
    for d in (32, 64, 128, 192, 256, 320, 512):
        for dtype in (bf16, torch.float32):
            x = fused_qkv(torch, gen, dev, 2, 300, 4, d, dtype)
            name = f"{str(dtype)[6:]} [2, 4, 300, {d}]"
            check_causal(torch, k2, f"{name} document mask", *x,
                         mask_f[:2, :300])
            check_causal(torch, k2, f"{name} offsets (100, 37)", *x,
                         mask_f[:2, :300], 100, 37)
    mask_h = wide_hold_mask(torch, dev)
    for d, dtype, label in wide_held(torch):
        x = fused_qkv(torch, gen, dev, 2, 200, 2, d, dtype)
        check_causal(torch, k2, f"{str(dtype)[6:]} [2, 2, 200, {d}] "
                     f"({label}) offsets (5, 23)", *x, mask_h, 5, 23)

    def time_causal(label, q, k, v, runs=25):
        B, _, T, _ = q.shape
        ms = time_ms(lambda: k2.flash_causal_cuda(q, k, v), torch, runs=runs,
                     flush=flush)
        full_ms = time_ms(lambda: k2.flash_cuda(q, k, v), torch, runs=runs,
                          flush=flush)
        plain_ms = time_ms(lambda: k2.flash_torch(q, k, v, causal=True),
                           torch, runs=5, warmup=1, flush=flush)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), torch, runs=runs, flush=flush)
        pairs = B * H * T * (T + 1) // 2
        bound_ms, by = bound(4 * pairs * D, 4 * B * H * T * D * 2, bw)
        print(f"phase 9: K2c {label}: {ms:.4f} ms; non-causal K2a "
              f"{full_ms:.4f} ms (K2a / K2c {full_ms / ms:.2f}: the pruning); "
              f"plain {plain_ms:.4f} ms; scaled_dot_product_attention"
              f"(is_causal=True) {lib_ms:.4f} ms; bound {bound_ms:.4f} ms by "
              f"{by} ({4 * pairs * D / 1e9:.2f} GFLOP over {pairs} allowed "
              "pairs at 989 TFLOP/s); median of CUDA-event runs, L2 flushed")
        return ms, plain_ms, bound_ms, by, lib_ms

    time_causal("bf16 [2, 8, 2048, 64]", *big)
    time_causal("bf16 [1, 8, 8192, 64]", *long_, runs=10)
    del big, long_
    c_ms, c_plain, c_bound, c_by, c_lib = time_causal(
        f"bf16 [{GEN_BATCH}, 8, {GEN_T - 1}, 64] (generate prefill)",
        *prefill)
    for x, mask_w in wide_inputs(torch, gen, dev, 3):
        time_wide(torch, "phase 9", "K2c", x,
                  lambda: k2.flash_causal_cuda(*x, mask_w),
                  lambda: k2.flash_torch(*x, mask_w, causal=True),
                  4 * wide_pairs(mask_w, x[0].shape[1], True), 4, bw, flush,
                  wide_sdpa(torch, x, mask_w, True, flush=flush))
    k2c = {"name": "flash_causal", "route": "cuda",
           "source": "mmlspark_torch/dl/csrc/flash_attn.cu",
           "replaces": "mmlspark_tpu/dl/pallas_attention.py:142",
           "launches": 0, "max_abs_err": max(errs), "ms": c_ms,
           "plain_ms": c_plain, "bound_ms": c_bound, "bound_by": c_by,
           "library_ms": c_lib}

    # ---- K3 through the switch's choice: the decode kernel up to 16
    # window rows (decode, verify), the window kernel above (prefill, the
    # long prompt); (name, seed, S, w, BL, MB, hd, full chains, timed)
    cases = [("w=1 S=32 BL=16 (decode)", 61, 32, 1, 16, 256, D, False, True),
             ("w=5 S=32 BL=16 (verify)", 62, 32, 5, 16, 256, D, False, True),
             ("w=128 S=32 BL=16 (prefill window)", 63, 32, 128, 16, 256, D,
              False, True),
             ("w=4096 S=1 BL=128 (long prompt)", 64, 1, 4096, 128, 32, D,
              True, True),
             ("w=1 S=1 BL=128 (decode at 4096 positions)", 73, 1, 1, 128, 32,
              D, True, True),
             ("w=5 S=32 BL=8 (verify)", 70, 32, 5, 8, 512, D, False, False),
             ("w=5 S=8 BL=128 (verify)", 71, 8, 5, 128, 32, D, False, False),
             ("w=1 S=32 BL=16 MB=1 (one chunk)", 72, 32, 1, 16, 1, D, False,
              False),
             ("w=5 S=32 BL=16 hd=32", 65, 32, 5, 16, 256, 32, False, False),
             ("w=5 S=32 BL=16 hd=128", 66, 32, 5, 16, 256, 128, False, False),
             ("w=5 S=32 BL=16 hd=16 (pools padded to 32)", 67, 32, 5, 16,
              256, 16, False, False),
             ("w=5 S=32 BL=16 hd=256", 68, 32, 5, 16, 256, 256, False, False),
             ("w=5 S=32 BL=16 hd=192 (pools padded to 256)", 69, 32, 5, 16,
              256, 192, False, False),
             ("w=1 S=32 BL=16 hd=320 (pools padded to 384)", 74, 32, 1, 16,
              64, 320, False, False),
             ("w=5 S=32 BL=16 hd=512", 75, 32, 5, 16, 64, 512, False, False),
             ("w=128 S=8 BL=16 hd=320 (window, pools padded to 384)", 76, 8,
              128, 16, 32, 320, False, False),
             ("w=64 S=8 BL=16 hd=512 (window)", 77, 8, 64, 16, 32, 512, False,
              False),
             ("w=64 S=4 BL=16 hd=1024 (window, 4- and 8-CTA clusters)", 78,
              4, 64, 16, 16, 1024, False, False),
             # the window kernel at the engine's own prefill shapes (phase
             # 11's tables: 18 blocks of 16), a warm suffix over a long
             # cached prefix (the plan splits the chain), short block
             # lengths (boxes under 8 rows; at hd 32 an odd one copies
             # through registers), every head dim
             ("w=192 S=1 BL=16 MB=18 (engine cold prefill)", 81, 1, 192, 16,
              18, D, False, True),
             ("w=192 S=4 BL=16 MB=18 (engine prefill batch)", 82, 4, 192, 16,
              18, D, False, True),
             ("w=32 S=1 BL=16 MB=18 (engine warm suffix)", 83, 1, 32, 16, 18,
              D, False, True),
             ("w=32 S=1 BL=16 MB=256 (warm suffix over a long prefix)", 84,
              1, 32, 16, 256, D, False, True),
             ("w=17 S=4 BL=8", 80, 4, 17, 8, 40, D, False, False),
             ("w=40 S=4 BL=4 (4-row boxes)", 85, 4, 40, 4, 40, D, False,
              False),
             ("w=40 S=4 BL=12 (4-row boxes)", 86, 4, 40, 12, 20, D, False,
              False),
             ("w=40 S=4 BL=5 hd=32 (register copies)", 87, 4, 40, 5, 32, 32,
              False, False),
             ("w=64 S=8 BL=16 hd=32 (window)", 88, 8, 64, 16, 32, 32, False,
              False),
             ("w=64 S=8 BL=16 hd=128 (window)", 89, 8, 64, 16, 32, 128, False,
              False),
             ("w=64 S=8 BL=16 hd=16 (window, pools padded to 32)", 91, 8, 64,
              16, 32, 16, False, False),
             ("w=64 S=8 BL=16 hd=256 (window)", 90, 8, 64, 16, 32, 256, False,
              False),
             ("w=64 S=8 BL=16 hd=192 (window, pools padded to 256)", 92, 8, 64,
              16, 32, 192, False, False),
             ("w=32 S=1 BL=16 MB=256 hd=256 (split)", 93, 1, 32, 16, 256, 256,
              False, False)]
    k3_err = {"decode": 0.0, "window": 0.0}
    records = {}
    for name, seed, S, w, BL, MB, hd, full, timed in cases:
        for dtype in (torch.float32, bf16):       # the bf16 case is timed
            c = paged_case(torch, dev, seed, S, w, BL, MB, H, hd, dtype, full)
            kind = "decode" if w <= k3.DECODE_MAX_ROWS else "window"
            for k, e in check_paged(torch, k3, f"{str(dtype)[6:]} {name}",
                                    c).items():
                k3_err[k] = max(k3_err[k], e)
        args = (c["q"], c["k_pool"], c["v_pool"], c["rows"], c["pos"])
        if kind == "decode":
            plan = k3.plan_of(k3.pad_head_dim(c["q"], c["k_pool"].shape[-1]),
                              c["k_pool"], c["rows"])
            print(f"phase 9: K3 decode plan {name}: {plan.n_chunks} chunks "
                  f"of {plan.L} positions, {plan.hg} heads and {plan.dpc} "
                  f"column chunks a CTA, {plan.P} positions a stage, "
                  f"{plan.ctas} CTAs")
            if "(decode)" in name and plan.n_chunks < 2:
                fail(f"K3 {name}: the decode shape's plan has one chunk; "
                     "the combine is not exercised")
            if "(one chunk)" in name and plan.n_chunks != 1:
                fail(f"K3 {name}: a one-chunk table planned "
                     f"{plan.n_chunks} chunks")
            if "(decode)" in name:
                runs = [k3.paged_decode_cuda(*args) for _ in range(2)]
                torch.cuda.synchronize()
                if not torch.equal(*runs):
                    fail(f"K3 {name}: two decode launches differ")
                print(f"phase 9: K3 {name}: two decode launches bit-equal")
        else:
            plan = k3.window_plan_of(
                k3.pad_head_dim(c["q"], c["k_pool"].shape[-1]), c["k_pool"],
                c["rows"])
            print(f"phase 9: K3 window plan {name}: {plan.n_qt} q tiles of "
                  f"128 rows, {plan.n_chunks} chunks of {plan.L} positions, "
                  f"{plan.ctas} CTAs")
            if ("long prefix" in name or "(split)" in name) \
                    and plan.n_chunks < 2:
                fail(f"K3 {name}: the plan does not split the chain; the "
                     "window kernel's partials and combine are not held")
            if any(k in name for k in ("(prefill window)", "(split)",
                                       "long prefix")):
                runs = [k3.paged_cuda(*args) for _ in range(2)]
                torch.cuda.synchronize()
                if not torch.equal(*runs):
                    fail(f"K3 {name}: two window kernel launches differ")
                print(f"phase 9: K3 {name}: two window kernel launches "
                      "bit-equal")
        if not timed:
            del c
            continue
        rec = k3_timings(torch, k3, name, c, S, w, BL, MB, H, hd, kind, bw,
                         flush)
        if "(decode)" in name or "(prefill window)" in name:
            records.update(rec)
        del c
    for kind, ids in (("decode", ("paged_decode", "paged_combine")),
                      ("window", ("paged_window",))):
        for rid in ids:
            records[rid]["max_abs_err"] = k3_err[kind]
    wide_window_times(torch, k3, dev, H, bw, flush)
    return [k2c, records["paged_decode"], records["paged_combine"],
            records["paged_window"]]


def wide_window_times(torch, k3, dev, H, bw, flush):
    """Time K3's window kernel on its wide route (pools at hd 512 in bf16,
    256 in f32) at the prefill window's shape (w = 128 over 32 slots of up
    to 4,096 positions) beside its plain version, its bound (the reached
    K/V blocks, q and o; 4 x pairs x hd operations) and SDPA on a cache
    gathered before the clock starts."""
    import torch.nn.functional as F
    S, w, BL, MB = 32, 128, 16, 256
    for hd, dtype in ((512, torch.bfloat16), (256, torch.float32)):
        c = paged_case(torch, dev, 63, S, w, BL, MB, H, hd, dtype)
        args = (c["q"], c["k_pool"], c["v_pool"], c["rows"], c["pos"])
        NB, L = c["k_pool"].shape[0], MB * BL
        idx = (c["rows"].long()[:, :, None] * BL
               + torch.arange(BL, device=dev)).reshape(S, L)
        kd, vd = (t.view(NB * BL, H, hd)[idx].transpose(1, 2).contiguous()
                  for t in (c["k_pool"], c["v_pool"]))
        lim = c["pos"].long()[:, None] + torch.arange(w, device=dev)
        allowed = (torch.arange(L, device=dev) <= lim[:, :, None])[:, None]
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            c["q"], kd, vd, attn_mask=allowed), torch, runs=10, flush=flush)
        del kd, vd, allowed
        pos = c["pos"].cpu().numpy().astype(np.int64) * c["active"]
        pairs = int(H * (w * (pos + 1) + w * (w - 1) // 2)[c["active"]].sum())
        es = c["q"].element_size()
        nbytes = (2 * int(c["nblk"].sum()) * BL * H * hd * es
                  + 2 * S * H * w * hd * es)
        time_wide(torch, "phase 9", "K3 window", [c["q"]],
                  lambda: k3.paged_cuda(*args), lambda: k3.paged_torch(*args),
                  4 * pairs, 0, bw, flush, lib_ms, nbytes=nbytes)
        del c


def device_ms(torch, fn, names, runs=10, flush=None, warm=True):
    """Per-kernel device time of one call of ``fn`` from ``torch.profiler``
    (the mean over ``runs`` calls, L2 flushed before each, after a warm
    call unless ``warm`` is false): ``{name: ms}`` summed over the kernels
    whose name contains each of ``names``."""
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        for n in names:
            if n in e.key:
                out[n] += e.device_time_total / runs / 1e3
    return out


K3_SOURCE = {"paged_decode": "paged_decode.cu",
             "paged_combine": "paged_decode.cu",
             "paged_window": "paged_attn.cu"}


def k3_timings(torch, k3, name, c, S, w, BL, MB, H, hd, kind, bw, flush):
    """Time K3 on one bf16 case: the switch's kernel (CUDA events around
    the call, as every kernel here; the decode call includes its combine)
    beside its bound, its plain version and SDPA on the gathered cache,
    and for a decode window the window kernel (the earlier K3) on the same
    inputs and the per-kernel device times. Returns the records of the
    kernels it timed."""
    import torch.nn.functional as F
    dev = c["q"].device
    args = (c["q"], c["k_pool"], c["v_pool"], c["rows"], c["pos"])
    run = k3.paged_decode_cuda if kind == "decode" else k3.paged_cuda
    ms = time_ms(lambda: run(*args), torch, flush=flush)
    plain_ms = time_ms(lambda: k3.paged_torch(*args), torch, runs=5,
                       warmup=1, flush=flush)
    # the library yardstick: SDPA over a dense cache gathered before the
    # clock starts, with a bool mask
    NB = c["k_pool"].shape[0]
    L = MB * BL
    idx = (c["rows"].long()[:, :, None] * BL
           + torch.arange(BL, device=dev)).reshape(S, L)

    def gather():
        return [p.view(NB * BL, H, hd)[idx].transpose(1, 2).contiguous()
                for p in (c["k_pool"], c["v_pool"])]

    gather_ms = time_ms(gather, torch, runs=10, flush=flush)
    kd, vd = gather()
    lim = c["pos"].long()[:, None] + torch.arange(w, device=dev)
    allowed = (torch.arange(L, device=dev) <= lim[:, :, None])[:, None]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        c["q"], kd, vd, attn_mask=allowed), torch, runs=10, flush=flush)
    del kd, vd, allowed
    pos = c["pos"].cpu().numpy().astype(np.int64) * c["active"]
    pairs = int(H * (w * (pos + 1) + w * (w - 1) // 2)[c["active"]].sum())
    nbytes = (2 * int(c["nblk"].sum()) * BL * H * hd * 2
              + 2 * S * H * w * hd * 2)
    bound_ms, by = bound(4 * pairs * hd, nbytes, bw)
    plan = ""
    if kind == "window":
        wp = k3.window_plan_of(k3.pad_head_dim(c["q"], c["k_pool"].shape[-1]),
                               c["k_pool"], c["rows"])
        dev_w = device_ms(torch, lambda: k3.paged_cuda(*args),
                          ("paged_fwd", "paged_combine"), flush=flush)
        plan = (f"; {wp.ctas} CTAs, {wp.n_chunks} chunk(s) of {wp.L} "
                f"positions; device time (torch.profiler) "
                f"{dev_w['paged_fwd']:.4f} ms + combine "
                f"{dev_w['paged_combine']:.4f} ms")
    print(f"phase 9: K3 {kind} kernel bf16 {name}: {ms:.4f} ms; plain "
          f"{plain_ms:.4f} ms; scaled_dot_product_attention on the gathered "
          f"cache {lib_ms:.4f} ms; bound {bound_ms:.4f} ms by {by} "
          f"({nbytes / 1e6:.2f} MB of reached K/V blocks, q and o; "
          f"{4 * pairs * hd / 1e9:.3f} GFLOP over {pairs} allowed pairs); "
          f"median of CUDA-event runs, L2 flushed{plan}")
    print(f"phase 9: K3 {name}: the dense gather alone {gather_ms:.4f} ms")
    source = "mmlspark_torch/dl/csrc/"
    replaces = "mmlspark_tpu/dl/pallas_paged_attention.py:89"
    rid = "paged_decode" if kind == "decode" else "paged_window"
    # "paged_attention" stays K3 at the decode shape (w = 1), the series it
    # named before the decode kernel took that shape over; the window
    # kernel's prefill window has a name of its own
    records = {rid: {"name": {"paged_decode": "paged_attention",
                              "paged_window": "paged_attention_window"}[rid],
                     "route": "cuda", "source": source + K3_SOURCE[rid],
                     "replaces": replaces, "launches": 0, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": by, "library_ms": lib_ms}}
    if kind != "decode":
        return records
    window_ms = time_ms(lambda: k3.paged_cuda(*args), torch, flush=flush)
    dev_ms = device_ms(torch, lambda: k3.paged_decode_cuda(*args),
                       ("paged_decode", "paged_combine"), flush=flush)
    win_dev = device_ms(torch, lambda: k3.paged_cuda(*args), ("paged_fwd",),
                        flush=flush)["paged_fwd"]
    print(f"phase 9: K3 {name}: decode kernel {ms:.4f} ms against the window "
          f"kernel (the earlier K3) {window_ms:.4f} ms, CUDA events around "
          f"the call; device time (torch.profiler) decode "
          f"{dev_ms['paged_decode']:.4f} ms + combine "
          f"{dev_ms['paged_combine']:.4f} ms against the window kernel "
          f"{win_dev:.4f} ms; the decode kernel's device time is "
          f"{bound_ms / max(dev_ms['paged_decode'], 1e-9):.2f} of its bound")
    # the combine: its own device time, its plain version on the same
    # partials, and its bound (the partials of the live chunks read, o
    # written)
    q = k3.pad_head_dim(c["q"], c["k_pool"].shape[-1])
    plan = k3.plan_of(q, c["k_pool"], c["rows"])
    m, l, acc = k3.paged_partials_torch(q, *args[1:], plan.L, plan.n_chunks,
                                        c["q"].shape[-1] ** -0.5)
    D = q.shape[-1]
    n_live = -(-(c["pos"].long() + w).clamp(0, MB * BL) // plan.L)
    combine_plain = time_ms(lambda: k3.paged_combine_torch(
        m, l, acc, n_live, torch.bfloat16), torch, runs=5, warmup=1,
        flush=flush)
    cbytes = int(n_live.sum()) * H * w * (D + 2) * 4 + S * H * w * D * 2
    c_bound, c_by = bound(3 * int(n_live.sum()) * H * w * D, cbytes, bw,
                          F32_PEAK_FLOPS)
    print(f"phase 9: K3 combine {name}: {dev_ms['paged_combine']:.4f} ms "
          f"(device time); plain {combine_plain:.4f} ms; bound "
          f"{c_bound:.4f} ms by {c_by} ({cbytes / 1e6:.2f} MB of live chunk "
          "partials and o)")
    records["paged_combine"] = {
        "name": "paged_attention_combine", "route": "cuda",
        "source": source + K3_SOURCE["paged_combine"], "replaces": replaces,
        "launches": 0, "ms": dev_ms["paged_combine"],
        "plain_ms": combine_plain, "bound_ms": c_bound, "bound_by": c_by,
        "library_ms": None}
    return records


def lm_model(torch, impl):
    """The causal LM of bench.py:896-930 at full width: the text encoder
    shape with an f32 LM head, weights seeded from torch.Generator 0."""
    from mmlspark_torch.dl import MaskedLMModel, TextEncoder, make_attention_fn
    gen = torch.Generator().manual_seed(0)
    return MaskedLMModel(TextEncoder(
        **TEXT_SHAPE, attention_fn=make_attention_fn(impl, causal=True),
        generator=gen), gen)


def rescore(torch, dense, seqs, start, dev, chunk=8):
    """Run the dense causal forward over each sequence (prompt plus
    generated) and read, at every generated position, how far the chosen
    token's logit lies below the dense maximum (pad excluded, as
    generation never emits it). Returns (share of positions where the
    chosen token is the dense argmax, largest gap)."""
    hits, total, worst = 0, 0, 0.0
    with torch.inference_mode():
        for i in range(0, len(seqs), chunk):
            ids = torch.from_numpy(np.ascontiguousarray(
                seqs[i:i + chunk])).to(dev)
            logits = dense(ids)["logits"][:, start - 1:-1].float()
            logits[..., 0] = float("-inf")
            chosen = ids[:, start:].long()
            best, arg = logits.max(-1)
            gap = best - logits.gather(-1, chosen[..., None])[..., 0]
            hits += int((arg == chosen).sum())
            total += chosen.numel()
            worst = max(worst, float(gap.max()))
            del logits
    return hits / total, worst


def hold_rescore(torch, name, dense, seqs, start, dev, fault=False):
    """Re-score ``seqs`` and hold every generated token within
    RESCORE_DELTA of the dense maximum; with ``fault`` the same limit must
    FAIL (a planted fault that passes means the limit is slack)."""
    share, gap = rescore(torch, dense, seqs, start, dev)
    ok = gap <= RESCORE_DELTA
    print(f"{name}: re-scored {len(seqs)} x {seqs.shape[1] - start} generated "
          f"tokens with the dense causal forward: {share:.4f} are the dense "
          f"argmax, largest gap {gap:.4f} (limit {RESCORE_DELTA}): "
          f"{'within' if ok else 'outside'} the limit")
    if ok == fault:
        fail(f"{name}: " + ("a planted fault passes the re-score limit: it "
                            "cannot tell a faulty kernel" if fault else
                            "generated tokens fail the re-score limit"))
    return share, gap


def counts(fns):
    return {name: fn.launches for name, fn in fns.items()}


def reset(fns):
    for fn in fns.values():
        fn.launches = 0
        if hasattr(fn, "combine_launches"):
            fn.combine_launches = 0


def with_k2c_one_tile_late(k2, fn):
    """Run ``fn()`` with a planted fault: K2c with its causal bound one tile
    (64 positions) late, so every row also sees the next 64 keys."""
    real = k2.flash_causal_cuda

    def shifted(q, k, v, key_mask=None, *, q_offset=0, k_offset=0):
        return real(q, k, v, key_mask, q_offset=q_offset + 64,
                    k_offset=k_offset)

    shifted.launches = 0                  # the real wrapper counts here
    k2.flash_causal_cuda = shifted
    try:
        return fn()
    finally:
        k2.flash_causal_cuda = real


def generate_phase(torch, k2, k3, dev, args):
    """Phase 10: ``generate`` at full width through K2c, against dense
    causal attention, with launch counts, the causality probe's drift and
    the re-scored tokens. Returns what phase 11 needs and K2c's launches
    in one steady generate call."""
    import copy

    from mmlspark_torch.dl import assert_causal, generate, make_attention_fn
    depth, vocab = TEXT_SHAPE["depth"], TEXT_SHAPE["vocab"]
    new = args.new_tokens
    fns = {"K2c": k2.flash_causal_cuda, "K2a": k2.flash_cuda,
           "K3 window": k3.paged_cuda, "K3 decode": k3.paged_decode_cuda}
    model = lm_model(torch, "pallas").to(dev).eval()
    dense = copy.deepcopy(model)
    dense.encoder = dense.encoder.with_attention(
        make_attention_fn("dense", causal=True))
    prompts = np.random.default_rng(11).integers(
        2, vocab, size=(GEN_BATCH, GEN_T)).astype(np.int32)

    reset(fns)
    t0 = time.perf_counter()
    out = generate(model, prompts, max_new_tokens=new)
    first_s = time.perf_counter() - t0
    got = counts(fns)
    want = {"K2c": 3 * depth, "K2a": 0, "K3 window": 0, "K3 decode": 0}
    if got != want:
        fail(f"launches in the first generate call {got}: expected {want} "
             "(16 for the causality probe's two forwards, 8 for the "
             "prefill)")
    if out.shape != (GEN_BATCH, GEN_T + new) or (out[:, GEN_T:] == 0).any():
        fail(f"generate returned {out.shape} with pad among the new tokens")

    def timed(m, n_new, runs=3):
        generate(m, prompts, max_new_tokens=n_new, max_len=GEN_T + new + 1)
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            generate(m, prompts, max_new_tokens=n_new,
                     max_len=GEN_T + new + 1)
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    for impl, m in (("pallas", model), ("dense", dense)):
        reset(fns)
        t_one, t_full = timed(m, 1), timed(m, new + 1)
        calls = counts(fns)
        want = {"K2c": 8 * depth if impl == "pallas" else 0, "K2a": 0,
                "K3 window": 0, "K3 decode": 0}
        if calls != want:
            fail(f"launches over 8 {impl} generate calls {calls}: expected "
                 f"{want} (one K2c launch per block per call with pallas)")
        if impl == "pallas":
            per_call = calls["K2c"] // 8
        step = (t_full - t_one) / new
        print(f"phase 10: generate, {impl} causal attention: prefill + one "
              f"step {t_one:.4f} s ({GEN_BATCH * GEN_T / t_one:,.0f} prompt "
              f"tokens/s); decode {step * 1e3:.3f} ms per step "
              f"({GEN_BATCH / step:,.0f} tokens/s), from {new + 1} against 1 "
              f"new tokens at max_len {GEN_T + new + 1}, medians of 3 calls")
    print(f"phase 10: first call (with the causality probe) {first_s:.3f} s; "
          f"launches K2c {got['K2c']}, then {per_call} per call; K3 0")
    drift = assert_causal(model, prompts[:1], vocab)
    print(f"phase 10: assert_causal drift {drift!r} (must be exactly 0)")
    if drift != 0.0:
        fail(f"the causality probe reads a drift of {drift} through K2c")
    hold_rescore(torch, "phase 10: generate", dense, out, GEN_T, dev)

    faulty = with_k2c_one_tile_late(k2, lambda: generate(
        model, prompts, max_new_tokens=new))
    hold_rescore(torch, "phase 10: planted fault (K2c bound one tile late)",
                 dense, faulty, GEN_T, dev, fault=True)
    return model, dense, prompts, out, per_call


def engine_phase(torch, k2, k3, dev, args, model, dense, prompts, gen_out):
    """Phase 11: the paged engine at full width through K3: cold and warm
    rounds with prefix hits, the 32-prompt throughput round, self-draft
    speculation and the 4096-token context, each re-scored; and a planted
    fault. Returns K3's launches in the throughput round."""
    from mmlspark_torch.obs import MetricsRegistry
    from mmlspark_torch.serving import LLMEngine
    from mmlspark_torch.serving.llm import _bucket_window
    depth, vocab = TEXT_SHAPE["depth"], TEXT_SHAPE["vocab"]
    new, svc = args.new_tokens, "llm"
    fns = {"K2c": k2.flash_causal_cuda, "K2a": k2.flash_cuda,
           "K3 window": k3.paged_cuda, "K3 decode": k3.paged_decode_cuda}

    def attn(reg, phase):
        h = reg.metrics("gen_decode_attn_seconds")[0]
        return h.count(service=svc, phase=phase), h.sum(service=svc,
                                                        phase=phase)

    def steps(reg, before):
        """(prefill batches, decode steps) since ``before``."""
        (pb, _), (st, _) = attn(reg, "prefill"), attn(reg, "decode")
        return pb - before[0], st - before[1]

    def hold_k3(reg, label, before, per_prefill=depth, per_step=depth):
        """K3 launches since ``before``: the window kernel per_prefill x
        prefill batches (their windows are wider than 16 rows), the decode
        kernel per_step x decode steps (decode and verify windows); K2c and
        K2a 0."""
        pb, st = steps(reg, before)
        got = counts(fns)
        want = {"K2c": 0, "K2a": 0, "K3 window": per_prefill * pb,
                "K3 decode": per_step * st}
        if got != want:
            fail(f"{label}: launches {got}, expected {want} ({per_prefill} "
                 f"per prefill batch x {pb}, {per_step} per decode step x "
                 f"{st})")
        hold_window_combine(label)
        return pb, st

    def hold_window_combine(label):
        """No prefill batch of these engines splits its chain: the tables
        hold 288, 176 or 64 positions, under two chunks of 512, and the
        long context's 4096-row window is 256 items, more than the SMs.
        So the window kernel's combine runs 0 times."""
        if k3.paged_cuda.combine_launches != 0:
            fail(f"{label}: {k3.paged_cuda.combine_launches} combine "
                 "launches after the window kernel, expected 0 (no engine "
                 "table here plans more than one chunk)")

    reg = MetricsRegistry()
    max_seq = 18 * 16
    num_blocks = 1 + 2 * 16 * 18
    eng = LLMEngine(model, slots=16, block_len=16, max_seq_len=max_seq,
                    num_blocks=num_blocks, prefill_batch=4, registry=reg,
                    device=dev)
    print(f"phase 11: engine slots 16, block_len 16, max_seq_len {max_seq}, "
          f"num_blocks {num_blocks} (given; blocks_for_hbm_budget would "
          "size the pools to half the free memory), prefill_batch 4")
    eng.warm(prefill_windows=(_bucket_window(GEN_T), 1))

    # rounds 1-2: one sequence in flight at a time, so TTFT is pure prefill
    rng = np.random.default_rng(13)
    shared = rng.integers(2, vocab, size=112)
    shared_prompts = [np.concatenate([shared, rng.integers(2, vocab, 17)])
                      for _ in range(4)]
    reset(fns)
    for rnd in range(2):
        for i, p in enumerate(shared_prompts):
            eng.submit(f"r{rnd}-{i}", p, 8)
            eng.run_until_drained()
    # a warm prompt's uncached suffix may be a prefill window of up to 16
    # rows, which takes the decode kernel: here only the two K3 kernels'
    # sum is exact, depth per prefill batch and per decode step
    pb, st = steps(reg, (0, 0))
    got = counts(fns)
    k3_sum = got.pop("K3 window") + got.pop("K3 decode")
    if got != {"K2c": 0, "K2a": 0} or k3_sum != depth * (pb + st):
        fail(f"rounds 1-2: launches {got}, K3 window + decode {k3_sum}, "
             f"expected K2c and K2a 0 and K3 {depth} x ({pb} prefill batches "
             f"+ {st} decode steps)")
    hold_window_combine("rounds 1-2")
    snap = reg.snapshot()
    hits = snap.get(f'kv_prefix_hits_total{{service="{svc}"}}', 0.0)
    misses = snap.get(f'kv_prefix_misses_total{{service="{svc}"}}', 0.0)
    h = reg.metrics("gen_ttft_seconds")[0]
    ttft = {r: (h.quantile(0.5, service=svc, reuse=r) * 1e3,
                h.count(service=svc, reuse=r)) for r in ("cold", "warm")}
    print(f"phase 11: rounds 1-2 (4 prompts of {GEN_T} tokens sharing a "
          f"112-token prefix, 8 new each, one at a time): TTFT p50 cold "
          f"{ttft['cold'][0]:.3f} ms ({ttft['cold'][1]} sequences), warm "
          f"{ttft['warm'][0]:.3f} ms ({ttft['warm'][1]}), from the registry's "
          f"buckets; prefix hit rate {hits / max(hits + misses, 1):.3f} "
          f"({int(hits)} hits, {int(misses)} misses); K3 launches per "
          f"prefill batch {depth} ({pb} batches, {st} decode steps)")

    # round 3: the 32 prompts of phase 10 at once
    before = (attn(reg, "prefill")[0], attn(reg, "decode")[0])
    dec0 = attn(reg, "decode")
    reset(fns)
    k3.paged_decode_cuda.combine_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.submit(i, p, new)
    out = eng.run_until_drained()
    wall = time.perf_counter() - t0
    pb, st = hold_k3(reg, "round 3", before)
    k3_launches = {"paged_window": fns["K3 window"].launches,
                   "paged_decode": fns["K3 decode"].launches,
                   "paged_combine": k3.paged_decode_cuda.combine_launches}
    if k3_launches["paged_combine"] != k3_launches["paged_decode"]:
        fail(f"round 3: {k3_launches['paged_combine']} combine launches for "
             f"{k3_launches['paged_decode']} decode launches: the 16-slot "
             "table's plan has more than one chunk, so each decode call "
             "combines")
    dec1 = attn(reg, "decode")
    seqs = np.stack([out[i] for i in range(len(prompts))])
    same = int(sum(np.array_equal(seqs[i], gen_out[i, :GEN_T + new])
                   for i in range(len(prompts))))
    print(f"phase 11: round 3 ({len(prompts)} prompts, {new} new tokens, all "
          f"at once): {wall:.3f} s, {len(prompts) * new / wall:,.0f} "
          f"tokens/s; {st} decode steps, "
          f"{(dec1[1] - dec0[1]) / max(st, 1) * 1e3:.3f} ms per step (host "
          f"clock, upload to fetch); {pb} prefill batches; K3 launches "
          f"{k3_launches} (window kernel {depth} per prefill batch, decode "
          f"kernel and its combine {depth} per decode step), K2c 0; {same} "
          f"of {len(prompts)} sequences identical to phase 10's")
    hold_rescore(torch, "phase 11: round 3", dense, seqs, GEN_T, dev)
    from mmlspark_torch.obs import compile_tracker
    mine = f"_{svc}_"
    OBS.update(engine=eng, engine_step_ms=(dec1[1] - dec0[1]) / max(st, 1)
               * 1e3, engine_compiles={
        n: st for n, st in compile_tracker.stats().items() if mine in n},
        engine_late={n: sigs for n, sigs in
                     compile_tracker.runtime_signatures().items()
                     if mine in n})
    del eng

    # self-draft speculation, k = 4, on 8 prompts
    k, spec_new = 4, min(new, 32)
    reg_s = MetricsRegistry()
    blocks = -(-(GEN_T + spec_new + k) // 16)
    eng = LLMEngine(model, draft_module=model, spec_k=k, slots=8,
                    block_len=16, max_seq_len=blocks * 16,
                    num_blocks=1 + 2 * 8 * blocks, prefill_batch=4,
                    registry=reg_s, device=dev)
    eng.warm(prefill_windows=(_bucket_window(GEN_T), 1))
    reset(fns)
    before = (attn(reg_s, "prefill")[0], attn(reg_s, "decode")[0])
    t0 = time.perf_counter()
    for i, p in enumerate(prompts[:8]):
        eng.submit(i, p, spec_new)
    out = eng.run_until_drained()
    wall = time.perf_counter() - t0
    pb, st = hold_k3(reg_s, "speculation", before, 2 * depth,
                     (k + 1) * depth + depth)
    ratio = reg_s.snapshot()[f'gen_spec_accept_ratio{{service="{svc}"}}']
    print(f"phase 11: self-draft spec_k={k}, 8 prompts, {spec_new} new: "
          f"{wall:.3f} s, {8 * spec_new / wall:,.0f} tokens/s, {st} decode "
          f"steps; accept ratio {ratio:.4f} (floor {SPEC_ACCEPT_MIN}); K3 "
          f"launches per decode step {(k + 1) * depth + depth} (draft "
          f"{(k + 1) * depth}, target {depth}), per prefill batch "
          f"{2 * depth}")
    if ratio < SPEC_ACCEPT_MIN:
        fail(f"self-draft accept ratio {ratio} below {SPEC_ACCEPT_MIN}")
    hold_rescore(torch, "phase 11: speculation", dense,
                 np.stack([out[i] for i in range(8)]), GEN_T, dev)
    del eng

    # the long context of llm_decode_scenario: 4064 prompt tokens, 32 new
    ctx, long_new = 4096, 32
    reg_l = MetricsRegistry()
    eng = LLMEngine(model, slots=1, block_len=128, max_seq_len=ctx,
                    num_blocks=1 + 2 * (ctx // 128), registry=reg_l,
                    device=dev)
    eng.warm(prefill_windows=(_bucket_window(ctx - long_new), 1))
    prompt = np.random.default_rng(23).integers(2, vocab, ctx - long_new)
    reset(fns)
    eng.submit("ctx", prompt, long_new)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = dict(eng.step())            # admit + prefill + first decode step
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out.update(eng.run_until_drained())
    decode_s = time.perf_counter() - t0
    hold_k3(reg_l, "long context", (0, 0))
    tokens = reg_l.snapshot()[f'gen_tokens_total{{service="{svc}"}}']
    # K3 alone at this context: one layer's launch over a 32-block chain
    pools = eng.pools[0]
    H = TEXT_SHAPE["heads"]
    q = torch.randn(1, H, 1, TEXT_SHAPE["width"] // H, device=dev,
                    dtype=torch.bfloat16)
    rows = torch.arange(1, ctx // 128 + 1, device=dev, dtype=torch.int32)
    last = torch.tensor([ctx - 1], device=dev, dtype=torch.int32)
    k3_ms = {fn.__name__: time_ms(lambda: fn(q, *pools, rows[None], last),
                                  torch)
             for fn in (k3.paged_decode_cuda, k3.paged_cuda)}
    dec_dev = device_ms(torch, lambda: k3.paged_decode_cuda(
        q, *pools, rows[None], last), ("paged_decode", "paged_combine"))
    print(f"phase 11: long context ({ctx - long_new} prompt tokens, "
          f"{long_new} new, block_len 128): prefill + first step "
          f"{prefill_s:.3f} s; decode {tokens - 1:.0f} steps in {decode_s:.3f} "
          f"s, {(tokens - 1) / decode_s:,.1f} tokens/s; K3 per step at {ctx} "
          f"positions ({depth} launches, CUDA events): decode kernel "
          f"{k3_ms['paged_decode_cuda'] * depth:.4f} ms ({depth} x "
          f"{k3_ms['paged_decode_cuda']:.4f}; device time decode "
          f"{dec_dev['paged_decode']:.4f} + combine "
          f"{dec_dev['paged_combine']:.4f} ms a launch), window kernel (the "
          f"earlier K3) {k3_ms['paged_cuda'] * depth:.4f} ms ({depth} x "
          f"{k3_ms['paged_cuda']:.4f})")
    hold_rescore(torch, "phase 11: long context", dense,
                 out["ctx"][None], ctx - long_new, dev)
    del eng

    # a planted fault: K3 with pos ignored in both kernels (every row
    # attends its whole chain, unwritten and later positions included); the
    # decode steps run it through the decode kernel
    reals = {n: getattr(k3, n) for n in ("paged_cuda", "paged_decode_cuda")}

    def no_pos(real):
        def run(q, k_pool, v_pool, rows, pos):
            return real(q, k_pool, v_pool, rows,
                        torch.full_like(pos, rows.shape[1] * k_pool.shape[1]))
        run.launches = run.combine_launches = 0   # the real one counts here
        return run

    eng = LLMEngine(model, slots=8, block_len=16, max_seq_len=max_seq,
                    num_blocks=1 + 2 * 8 * 18, prefill_batch=4,
                    registry=MetricsRegistry(), device=dev)
    faults = {n: no_pos(real) for n, real in reals.items()}
    for n, fault in faults.items():
        setattr(k3, n, fault)
    try:
        for i, p in enumerate(prompts[:8]):
            eng.submit(i, p, 16)
        out = eng.run_until_drained()
    finally:
        for n, real in reals.items():
            setattr(k3, n, real)
    if faults["paged_decode_cuda"].launches == 0:
        fail("the planted fault's decode steps did not reach the decode "
             "kernel")
    hold_rescore(torch, "phase 11: planted fault (K3 with pos ignored)",
                 dense, np.stack([out[i] for i in range(8)]), GEN_T, dev,
                 fault=True)
    padded_engine(torch, k3, dev)
    return k3_launches


def padded_engine(torch, k3, dev):
    """Phase 11: an engine at hd 16 (width 128, 8 heads) sized by
    ``num_blocks=None`` at the default ``hbm_fraction`` 0.5, with a self-
    draft: the pools (the draft's too) are allocated at K3's head dim 32,
    their bytes must equal ``num_blocks`` x the engine's block bytes and
    stay within half the free memory; the engine serves 4 prompts through
    K3 and its tokens are re-scored with the dense forward."""
    import copy

    from mmlspark_torch.dl import (MaskedLMModel, TextEncoder,
                                   make_attention_fn)
    from mmlspark_torch.dl.paged_kv import pool_block_bytes
    from mmlspark_torch.obs import MetricsRegistry
    from mmlspark_torch.serving import LLMEngine
    gen = torch.Generator().manual_seed(0)
    model = MaskedLMModel(TextEncoder(
        vocab=4096, width=128, depth=2, heads=8, mlp_dim=512,
        attention_fn=make_attention_fn("pallas", causal=True),
        generator=gen), gen).to(dev).eval()
    dense = copy.deepcopy(model)
    dense.encoder = dense.encoder.with_attention(
        make_attention_fn("dense", causal=True))
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0]
    eng = LLMEngine(model, draft_module=model, spec_k=2, slots=4,
                    block_len=16, max_seq_len=64, registry=MetricsRegistry(),
                    device=dev)
    pools = [t for layer in eng.pools + eng.draft_pools for t in layer]
    held = sum(t.numel() * t.element_size() for t in pools)
    block_bytes = 2 * pool_block_bytes(model.encoder, 16)
    hd = {t.shape[-1] for t in pools}
    print(f"phase 11: hd-16 engine sized by num_blocks=None: "
          f"{eng.kv.num_blocks} blocks of {block_bytes} B (pools at head "
          f"dim {sorted(hd)}), {held / 2**30:.3f} GiB held of "
          f"{free / 2**30:.3f} GiB free before")
    if hd != {32} or held != eng.kv.num_blocks * block_bytes \
            or held > 0.5 * free:
        fail(f"hd-16 engine: pools at head dims {hd} (want {{32}}) hold "
             f"{held} B for {eng.kv.num_blocks} blocks of {block_bytes} B, "
             f"limit half of {free} B free")
    prompts = np.random.default_rng(17).integers(
        2, 4096, size=(4, 40)).astype(np.int32)
    before = (k3.paged_cuda.launches, k3.paged_decode_cuda.launches)
    for i, p in enumerate(prompts):
        eng.submit(i, p, 16)
    out = eng.run_until_drained()
    if (k3.paged_cuda.launches, k3.paged_decode_cuda.launches) <= before:
        fail("hd-16 engine: K3's window or decode kernel was not launched")
    hold_rescore(torch, "phase 11: hd-16 engine", dense,
                 np.stack([out[i] for i in range(4)]), 40, dev)
    del eng, pools
    torch.cuda.empty_cache()


def llm_phases(torch, k1, k2, k3, dev, bw, flush, lengths, args):
    """Phases 9-11. Returns the K2c record and K3's (the decode kernel, its
    combine and the window kernel) for the kernels line."""
    with Phase("phase 9"):
        k2c, *k3recs = llm_kernel_phase(torch, k2, k3, dev, bw, flush,
                                        lengths)
    with Phase("phase 10"):
        model, dense, prompts, out, k2c["launches"] = generate_phase(
            torch, k2, k3, dev, args)
    with Phase("phase 11"):
        launches = engine_phase(torch, k2, k3, dev, args, model, dense,
                                prompts, out)
    for rec, rid in zip(k3recs, ("paged_decode", "paged_combine",
                                 "paged_window")):
        rec["launches"] = launches[rid]
    return [k2c, *k3recs]


# ------------------------------------------------------ causal training

def causal_counters(k2):
    """The launch counters phase 13 reads: each kernel's causal and
    non-causal launches apart."""
    return {"K2c-lse": (k2.flash_lse_cuda, "causal_launches"),
            "causal K2d": (k2.flash_dq_cuda, "causal_launches"),
            "causal K2e": (k2.flash_dkv_cuda, "causal_launches"),
            "K2c": (k2.flash_causal_cuda, "launches"),
            "K2a": (k2.flash_cuda, "launches"),
            "K2b": (k2.flash_lse_cuda, "launches"),
            "K2d": (k2.flash_dq_cuda, "launches"),
            "K2e": (k2.flash_dkv_cuda, "launches")}


def read_counts(counters):
    return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}


def zero_counts(counters):
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def causal_kernel_phase(torch, k2, dev, bw, flush, lengths, B):
    """Phase 12: K2c-lse, causal K2d and causal K2e against their plain
    versions at the causal training path's attention shape and beside, then
    their times. Returns the three records (launches filled in by phase
    13)."""
    T, H, W = TEXT_T, TEXT_SHAPE["heads"], TEXT_SHAPE["width"]
    D = W // H
    mask_np = np.arange(T)[None, :] < lengths[:B, None]
    mask_np[-1] = False                           # one fully masked row
    mask = torch.from_numpy(mask_np).to(dev)
    gen = torch.Generator(device=dev).manual_seed(51)
    q, k, v = fused_qkv(torch, gen, dev, B, T, H, D, torch.bfloat16)
    dout = torch.randn(B, T, H, D, generator=gen, device=dev,
                       dtype=torch.bfloat16).transpose(1, 2)
    dlse = torch.randn(B, H, T, generator=gen, device=dev)
    shape = f"bf16 [{B}, {H}, {T}, {D}]"
    errs = [0.0, 0.0, 0.0]
    for q_off, k_off in ((0, 0), (2048, 0), (100, 37), (0, 2048)):
        got = check_training_kernels(
            torch, k2, f"{shape} offsets ({q_off}, {k_off})", q, k, v, dout,
            mask, dlse, q_off, k_off)
        errs = [max(a, b) for a, b in zip(errs, got)]
    Tf = 2000
    xf = fused_qkv(torch, gen, dev, B, Tf, H, D, torch.float32)
    mask_f = mask[:, :Tf].clone()
    mask_f[0] = False
    check_training_kernels(
        torch, k2, f"f32 ragged [{B}, {H}, {Tf}, {D}] offsets (100, 37)",
        *xf, torch.randn(B, H, Tf, D, generator=gen, device=dev), mask_f,
        dlse[:, :, :Tf], 100, 37)
    del xf
    for d in (32, 64, 128, 192, 256, 320, 512):
        for dtype in (torch.bfloat16, torch.float32):
            x = fused_qkv(torch, gen, dev, 2, 300, 4, d, dtype)
            name = f"{str(dtype)[6:]} [2, 4, 300, {d}] offsets (5, 23)"
            dout_x = torch.randn(2, 4, 300, d, generator=gen, device=dev,
                                 dtype=dtype)
            check_training_kernels(
                torch, k2, name, *x, dout_x, mask_f[:2, :300],
                torch.randn(2, 4, 300, generator=gen, device=dev), 5, 23)
            if d in (256, 512) and (d == 512) == (dtype == torch.bfloat16):
                deterministic(torch, k2, f"phase 12 ({name}, wide)", *x,
                              dout_x, mask_f[:2, :300], True)
    mask_h = wide_hold_mask(torch, dev)
    for d, dtype, label in wide_held(torch):  # wider clusters, then split
        x = fused_qkv(torch, gen, dev, 2, 200, 2, d, dtype)
        check_training_kernels(
            torch, k2, f"{str(dtype)[6:]} [2, 2, 200, {d}] ({label}) "
            "offsets (5, 23)", *x, torch.randn(2, 2, 200, d, generator=gen,
                                               device=dev, dtype=dtype),
            mask_h, torch.randn(2, 2, 200, generator=gen, device=dev), 5, 23)
    deterministic(torch, k2, "phase 12", q, k, v, dout, mask, True)
    wide_training_times(torch, k2, "phase 12", dev, gen, bw, flush, True)

    # the library yardsticks: SDPA with the causal and key mask as one bool
    # mask (the same function), and SDPA is_causal=True without the key
    # mask (its causal fast path)
    allowed = mask[:, None, None, :] & torch.ones(
        T, T, dtype=torch.bool, device=dev).tril()
    sdpa = sdpa_times(torch, q, k, v, dout, flush, attn_mask=allowed)
    del allowed
    sdpa_causal = sdpa_times(torch, q, k, v, dout, flush, is_causal=True)
    # the work this input needs: each query row against the valid keys at
    # or before it (P allowed pairs per head); skipped tiles are not work
    pairs = H * int(mask.long().cumsum(1).sum())
    records = training_kernel_records(torch, k2, "phase 12", q, k, v, mask,
                                      dout, True, pairs, sdpa, errs, bw,
                                      flush)
    print(f"phase 12: scaled_dot_product_attention with the causal key mask "
          f"forward {sdpa[0]:.4f} ms (beside K2c-lse), backward "
          f"{sdpa[1]:.4f} ms (beside causal K2d + K2e "
          f"{records[1]['ms'] + records[2]['ms']:.4f} ms); is_causal=True "
          f"without the key mask forward {sdpa_causal[0]:.4f} ms, backward "
          f"{sdpa_causal[1]:.4f} ms")
    return records


def causal_train_phase(torch, k2, dev, texts, args, records):
    """Phase 13: causal-LM pretraining at full width through the causal
    training kernels: launch counts and timed windows, one step's gradients
    against dense causal attention with a planted fault, a remat step, then
    ``generate`` on the trained weights, re-scored. Fills in the records'
    launches."""
    import copy

    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.dl import (assert_causal, generate,
                                   make_attention_fn, masked_xent,
                                   pretrain_causal_lm)
    from mmlspark_torch.featurize import TokenIdEncoder

    B, S = args.batch, args.train_steps
    depth, vocab = TEXT_SHAPE["depth"], TEXT_SHAPE["vocab"]
    ids = np.asarray(TokenIdEncoder(maxLength=TEXT_T + 1, vocabSize=vocab)
                     .transform(DataFrame({"text": texts}))["tokens"])
    counters = causal_counters(k2)
    model = lm_model(torch, "pallas")
    pretrain_causal_lm(model, ids, steps=1, batch_size=B, seed=100)  # warm
    torch.cuda.synchronize()
    probe = []
    for _ in range(TRAIN_RUNS):
        t0 = time.perf_counter()
        assert_causal(model, ids[:1], vocab)
        torch.cuda.synchronize()
        probe.append(time.perf_counter() - t0)
    probe_s = float(np.median(probe))
    windows, counts, losses = [], [], []
    for run in range(TRAIN_RUNS):
        zero_counts(counters)
        t0 = time.perf_counter()
        state, run_losses = pretrain_causal_lm(model, ids, steps=S,
                                               batch_size=B, seed=run)
        torch.cuda.synchronize()
        windows.append(time.perf_counter() - t0)
        counts.append(read_counts(counters))
        losses += run_losses
    want = {"K2c-lse": depth * S, "causal K2d": depth * S,
            "causal K2e": depth * S, "K2c": 2 * depth, "K2a": 0, "K2b": 0,
            "K2d": 0, "K2e": 0}
    if any(c != want for c in counts):
        fail(f"launches per pretrain_causal_lm call of {S} steps {counts}: "
             f"expected {want}: one K2c-lse, causal K2d and causal K2e "
             "launch per block per step, the probe's two forwards through "
             "K2c, and no non-causal launch")
    if not np.isfinite(losses).all():
        fail(f"non-finite causal pretraining losses {losses}")
    step_s = (float(np.median(windows)) - probe_s) / S
    targets = []
    for run in range(TRAIN_RUNS):              # the timed windows' batches
        rng = np.random.default_rng(run)
        for _ in range(S):
            rows = ids[rng.integers(0, len(ids), size=B)]
            targets.append(int((rows[:, 1:] != 0).sum()))
    print(f"phase 13: pretrain_causal_lm, batch {B} x T={TEXT_T} (rows of "
          f"{TEXT_T + 1} tokens), {TEXT_SHAPE}, causal pallas, AdamW: step "
          f"{step_s:.4f} s ({B / step_s:.2f} seqs/s, "
          f"{np.mean(targets) / step_s:,.0f} non-pad target tokens/s): "
          f"median over {TRAIN_RUNS} calls of {S} steps "
          f"({', '.join(f'{w:.4f}' for w in windows)} s) less the "
          f"causality probe each call runs first ({probe_s:.4f} s, median "
          f"of {TRAIN_RUNS}); launches per step K2c-lse "
          f"{counts[-1]['K2c-lse'] // S}, causal K2d "
          f"{counts[-1]['causal K2d'] // S}, causal K2e "
          f"{counts[-1]['causal K2e'] // S}, per call K2c "
          f"{counts[-1]['K2c']} (the probe), K2a/K2b/K2d/K2e 0; losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    for r, kid in zip(records, KERNEL_IDS[True]):
        r["launches"] = counts[-1][kid] // S

    # one step's loss and gradients through the kernels against autograd
    # through dense causal attention, on the same weights and batch
    base = lm_model(torch, "pallas")
    rng = np.random.default_rng(0)
    rows = ids[rng.integers(0, len(ids), size=B)]
    x = torch.from_numpy(np.ascontiguousarray(rows[:, :-1])).to(dev)
    y = torch.from_numpy(np.where(rows[:, 1:] != 0, rows[:, 1:], -1)
                         .astype(np.int32)).to(dev)

    def loss_and_grads(impl, remat=False):
        m = copy.deepcopy(base)
        m.encoder = m.encoder.with_attention(make_attention_fn(
            impl, causal=True))
        m.encoder.remat = remat
        m.to(dev)
        loss = masked_xent(m(x, train=True)["logits"], y)
        loss.backward()
        grads = {n: p.grad.float() for n, p in m.named_parameters()}
        return float(loss.detach()), grads

    zero_counts(counters)
    kernels = loss_and_grads("pallas")
    step_counts = read_counts(counters)
    dense = loss_and_grads("dense")
    print("phase 13: per-parameter gradients, kernels (pallas) vs dense "
          "causal attention:")
    if not compare_grads("phase 13", "pallas", kernels, dense, True):
        fail("causal gradients through the kernels and through dense "
             "attention disagree beyond the limits")
    real_dkv = k2.flash_dkv_cuda

    def late(*a, causal=False, q_offset=0, k_offset=0):
        return real_dkv(*a, causal=causal, q_offset=q_offset - 64,
                        k_offset=k_offset)

    late.launches = late.causal_launches = 0  # the real wrapper counts
    k2.flash_dkv_cuda = late
    try:
        faulty = loss_and_grads("pallas")
    finally:
        k2.flash_dkv_cuda = real_dkv
    if compare_grads("phase 13", "planted fault (causal K2e's bound one q "
                     "tile late)", faulty, dense, False):
        fail("the gradient limits pass causal K2e starting one q tile late: "
             "they cannot tell a backward that drops the diagonal tiles")
    del faulty, dense

    # remat: the same step with every block recomputed in the backward
    zero_counts(counters)
    remat = loss_and_grads("pallas", remat=True)
    remat_counts = read_counts(counters)
    want_step = dict(want, **{"K2c-lse": depth, "causal K2d": depth,
                              "causal K2e": depth, "K2c": 0})
    if step_counts != want_step or remat_counts != dict(
            want_step, **{"K2c-lse": 2 * depth}):
        fail(f"launches in one step {step_counts}, with remat "
             f"{remat_counts}: expected {depth} of each causal kernel, and "
             f"{2 * depth} K2c-lse with remat (the forward runs again in "
             "the backward)")
    worst = max(float((remat[1][n] - g).norm() / g.norm().clamp_min(1e-30))
                for n, g in kernels[1].items())
    dloss = abs(remat[0] - kernels[0])
    print(f"phase 13: remat=True step vs the plain step through the "
          f"kernels: |dloss| {dloss:.3g}, worst ||dg||/||g|| {worst:.3g} "
          f"(limits {REMAT_LOSS_MAX}, {REMAT_GRAD_REL_MAX}); K2c-lse "
          f"launches {remat_counts['K2c-lse']} (plain step "
          f"{step_counts['K2c-lse']}), causal K2d/K2e "
          f"{remat_counts['causal K2d']}/{remat_counts['causal K2e']}")
    if dloss > REMAT_LOSS_MAX or worst > REMAT_GRAD_REL_MAX:
        fail("the remat step's loss or gradients differ from the plain "
             "step's")
    del kernels, remat, base

    # the trained weights generate through K2c, re-scored by dense
    trained = state.model.eval()
    dense_lm = copy.deepcopy(trained)
    dense_lm.encoder = dense_lm.encoder.with_attention(
        make_attention_fn("dense", causal=True))
    prompts = np.ascontiguousarray(ids[:8, :GEN_T])
    if (prompts == 0).any():
        fail("a generate prompt holds pad")
    zero_counts(counters)
    out = generate(trained, prompts, max_new_tokens=CAUSAL_GEN_NEW)
    got = read_counts(counters)
    if got != dict({n: 0 for n in got}, K2c=3 * depth):
        fail(f"launches in generate on the trained model {got}: expected "
             f"K2c {3 * depth} (the probe and the prefill) and nothing else")
    hold_rescore(torch, "phase 13: generate on the trained weights",
                 dense_lm, out, GEN_T, dev)
    # a few AdamW steps from random weights favour the corpus' frequent
    # tokens by a wide margin, so the argmax rarely depends on the context
    # and a faulty prefill need not change a token: the trained model's own
    # causal forward (K2c) over the generated sequences is held against
    # the dense one logit by logit, and a planted fault must fail that
    drift = logit_drift(torch, trained, dense_lm, out, GEN_T, dev)
    faulty = with_k2c_one_tile_late(k2, lambda: logit_drift(
        torch, trained, dense_lm, out, GEN_T, dev))
    print(f"phase 13: the trained model's causal forward through K2c vs "
          f"dense over the generated sequences: max |dlogit| {drift:.4f} at "
          f"the {CAUSAL_GEN_NEW} generated positions (limit "
          f"{LOGIT_DRIFT_MAX}); planted fault (K2c bound one tile late) "
          f"{faulty:.4f}")
    if drift > LOGIT_DRIFT_MAX:
        fail("the trained model's logits through K2c and through dense "
             "causal attention disagree beyond the limit")
    if faulty <= LOGIT_DRIFT_MAX:
        fail("the logit limit passes K2c one tile late: it cannot tell a "
             "faulty kernel")


def logit_drift(torch, model, dense, seqs, start, dev, chunk=8):
    """The largest |logit difference| between ``model``'s causal forward
    (its own attention, without grad) and ``dense``'s over ``seqs``, at
    the positions that predict tokens ``start`` onwards."""
    worst = 0.0
    with torch.inference_mode():
        for i in range(0, len(seqs), chunk):
            ids = torch.from_numpy(np.ascontiguousarray(
                seqs[i:i + chunk])).to(dev)
            a = model(ids)["logits"][:, start - 1:-1].float()
            b = dense(ids)["logits"][:, start - 1:-1].float()
            worst = max(worst, float((a - b).abs().max()))
            del a, b
    return worst


def causal_phases(torch, k2, dev, bw, flush, texts, lengths, args):
    """Phases 12-13. Returns the K2c-lse, causal K2d and causal K2e
    records for the kernels line."""
    with Phase("phase 12"):
        records = causal_kernel_phase(torch, k2, dev, bw, flush, lengths,
                                      args.batch)
    with Phase("phase 13"):
        causal_train_phase(torch, k2, dev, texts, args, records)
    return records


# ---------------------------------------------------------- featurize slice

FEAT_NAN_COLS = (1, 4, 8, 12, 17, 21, 26)   # 2 % NaN planted in each
FEAT_CLEAN_COLS = ("f1", "f4", "f8")        # CleanMissingData's, Median
FEAT_RUNS = 3                 # warm stage fits/transforms timed (median)
CHAIN_FITS = 2                # chain fits, K1 launches held equal
FILL_RTOL = 1e-6              # card fills against device="cpu" fills
CHAIN_AUC_ATOL = 1e-3         # chain AUC against the numpy-assembled fit
W2V_GROUPS, W2V_GROUP_WORDS = 200, 10
W2V_SENTENCES, W2V_LEN = 25_000, 12         # 300,000 tokens
W2V_KW = dict(vectorSize=100, windowSize=5, numNegatives=5, maxIter=3)
W2V_QUALITY_MIN = 0.9         # nearest neighbour in the word's own group
W2V_TRANSFORM_ATOL = 1e-5     # card transform against device="cpu"


def raw_frame(rows: int) -> dict:
    """``higgs_like``'s rows as 28 separate float32 columns, 2 % NaN in
    seven of them, a 12-level and a 2,000-level string column, a bool and a
    datetime64[s] column; the label also depends on the strings and the
    bool (seed 23)."""
    feats, _ = higgs_like(rows)
    rng = np.random.default_rng(23)
    city = rng.integers(0, 12, rows)
    item = rng.integers(0, 2000, rows)
    flag = rng.random(rows) < 0.4
    margin = (feats[:, :4].sum(1) + feats[:, 4] * feats[:, 5]
              + rng.normal(0, 1, 12)[city] + rng.normal(0, 1, 2000)[item]
              + 0.5 * flag)
    cols = {f"f{i}": np.ascontiguousarray(feats[:, i]) for i in range(28)}
    for i in FEAT_NAN_COLS:
        cols[f"f{i}"][rng.random(rows) < 0.02] = np.nan
    cols["city"] = np.asarray([f"city{i:02d}" for i in range(12)],
                              object)[city]
    cols["item"] = np.asarray([f"item{i:04d}" for i in range(2000)],
                              object)[item]
    cols["flag"] = flag
    cols["when"] = np.datetime64("2024-01-01T00:00:00") + rng.integers(
        0, 30_000_000, rows).astype("timedelta64[s]")
    cols["label"] = (margin + rng.normal(size=rows) > 0).astype(np.float32)
    return cols


def numpy_assembly(cols: dict, clean_fills: dict, plan: list,
                   onehot_shift: int = 0) -> np.ndarray:
    """The features that fitted ``CleanMissingData`` fills and a fitted
    ``Featurize`` plan give the raw frame, built in numpy on the host
    (levels by lookup, crc32 over the distinct strings). ``onehot_shift``
    moves every one-hot slot by that many places (a planted fault)."""
    import zlib
    n = len(cols["label"])
    blocks = []
    for spec in plan:
        x, kind, w = cols[spec["col"]], spec["kind"], spec["width"]
        if kind == "numeric":
            v = x.astype(np.float32)
            if spec["col"] in clean_fills:
                v = np.where(np.isnan(v),
                             np.float32(clean_fills[spec["col"]]), v)
            blocks.append(np.where(np.isnan(v), np.float32(spec["fill"]),
                                   v)[:, None])
        elif kind in ("onehot", "hash"):
            uniq, inv = np.unique(x.astype(str), return_inverse=True)
            if kind == "onehot":
                lookup = {lvl: i for i, lvl in enumerate(spec["levels"])}
                slot = np.asarray([lookup[u] for u in uniq])
                slot = (slot + onehot_shift) % w
            else:
                slot = np.asarray([zlib.crc32(u.encode("utf-8"))
                                   & 0x7FFFFFFF for u in uniq]) % w
            m = np.zeros((n, w), np.float32)
            m[np.arange(n), slot[inv]] = 1.0
            blocks.append(m)
        elif kind == "datetime":
            blocks.append(x.astype("datetime64[s]").astype(np.float64)
                          .astype(np.float32)[:, None])
        else:
            fail(f"phase 14: no numpy assembly for plan kind {kind!r}")
    return np.concatenate(blocks, axis=1)


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a.view(np.uint32), b.view(np.uint32))


def featurize_chain_phase(torch, k1, args) -> int:
    """Phase 14: raw columns → CleanMissingData → Featurize →
    LightGBMClassifier → AUC on the card. Returns K1's launches per chain
    fit."""
    from mmlspark_torch.core import DataFrame, Pipeline
    from mmlspark_torch.featurize import CleanMissingData, Featurize
    from mmlspark_torch.lightgbm import LightGBMClassifier
    from mmlspark_torch.train import ComputeModelStatistics

    n = args.rows
    t0 = time.perf_counter()
    cols = raw_frame(n)
    inputs = [c for c in cols if c != "label"]
    df = DataFrame(cols)
    print(f"phase 14: raw frame {n:,} rows x {len(inputs)} columns "
          f"(28 float32, 2 % NaN in {len(FEAT_NAN_COLS)}; strings of 12 "
          f"and 2,000 levels; bool; datetime64[s]) made in "
          f"{time.perf_counter() - t0:.2f} s")
    clean = CleanMissingData(inputCols=list(FEAT_CLEAN_COLS),
                             cleaningMode="Median")
    feat = Featurize(inputCols=inputs, numFeatures=32)

    def timed(fn):
        """Warm call, then the median of FEAT_RUNS, each ending in a
        synchronize."""
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(FEAT_RUNS):
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return out, float(np.median(times))

    clean_model, clean_fit_s = timed(lambda: clean.fit(df))
    cleaned, clean_tr_s = timed(lambda: clean_model.transform(df))
    feat_model, feat_fit_s = timed(lambda: feat.fit(cleaned))
    host_times = []

    def feat_transform():
        out = feat_model.transform(cleaned)
        host_times.append(feat_model.host_encode_seconds)
        return out

    featurized, feat_tr_s = timed(feat_transform)
    host_s = float(np.median(host_times[1:]))
    plan = feat_model.getEncodingPlan()
    kinds = [spec["kind"] for spec in plan]
    for name, fit_s, tr_s in (("CleanMissingData", clean_fit_s, clean_tr_s),
                              ("Featurize", feat_fit_s, feat_tr_s)):
        print(f"phase 14: {name} fit {fit_s:.4f} s ({n / fit_s:,.0f} "
              f"rows/s), transform {tr_s:.4f} s ({n / tr_s:,.0f} rows/s); "
              f"warm, median of {FEAT_RUNS}, each ending in a synchronize")
    print(f"phase 14: Featurize plan {len(plan)} columns -> "
          f"{feat_model.feature_dim} slots ({kinds.count('numeric')} "
          f"numeric, {kinds.count('onehot')} one-hot, {kinds.count('hash')} "
          f"hash, {kinds.count('datetime')} datetime); the transform's "
          f"host string encodings {host_s:.4f} s (median of the timed "
          f"runs, {host_s / feat_tr_s:.1%}); the rest, "
          f"{feat_tr_s - host_s:.4f} s, is the numeric columns' casts and "
          "copies, imputation and concatenation on the card and the copy "
          "back")

    # (a) the card's features, bit for bit, against a numpy assembly; (e)
    # the assembly with the 12-level one-hot one slot late must not pass
    got = featurized["features"]
    want = numpy_assembly(cols, clean_model.getFillValues(), plan)
    if not same_bits(got, want):
        bad = np.argwhere(got != want)
        fail(f"phase 14: Featurize on the card differs from the numpy "
             f"assembly at {len(bad)} cells, first {bad[:3].tolist()}")
    if same_bits(got, numpy_assembly(cols, clean_model.getFillValues(),
                                     plan, onehot_shift=1)):
        fail("phase 14: the planted fault (one-hot one slot late) passed "
             "the bit-for-bit comparison")
    print(f"phase 14: features {got.shape} float32 equal the numpy "
          "assembly bit for bit; the one-hot shifted by one slot (planted "
          "fault) differs, as it must")

    # (b) the fills against the same stages fitted on the CPU
    cpu_clean = CleanMissingData(inputCols=list(FEAT_CLEAN_COLS),
                                 cleaningMode="Median", device="cpu").fit(df)
    cpu_plan = Featurize(inputCols=inputs, numFeatures=32,
                         device="cpu").fit(cleaned).getEncodingPlan()
    pairs = [(f"clean {c}", clean_model.getFillValues()[c],
              cpu_clean.getFillValues()[c]) for c in FEAT_CLEAN_COLS]
    for spec, cpu_spec in zip(plan, cpu_plan):
        if {k: v for k, v in spec.items() if k != "fill"} != \
                {k: v for k, v in cpu_spec.items() if k != "fill"}:
            fail(f"phase 14: plan entry {spec['col']!r} differs on the CPU")
        if "fill" in spec:
            pairs.append((spec["col"], spec["fill"], cpu_spec["fill"]))
    worst = max(abs(a - b) / max(abs(b), 1e-30) for _, a, b in pairs)
    if worst > FILL_RTOL:
        fail(f"phase 14: a fill differs from the CPU's by {worst:.2e} "
             f"relative (limit {FILL_RTOL})")
    print(f"phase 14: {len(pairs)} fills within {worst:.2e} relative of "
          f"the CPU's (limit {FILL_RTOL})")

    # (c) the chain through Pipeline.fit, K1 counted; the plain histogram
    # counted through the switch it is reached by
    gbdt = dict(numIterations=args.iterations, numLeaves=31, maxBin=255,
                learningRate=0.1)
    pipe = Pipeline(stages=[clean, feat, LightGBMClassifier(**gbdt)])
    plain_calls, restore = counting_plain(k1)
    try:
        fit_times, launches = [], []
        for _ in range(CHAIN_FITS):
            k1.hist_cuda.launches = 0
            t = time.perf_counter()
            chain = pipe.fit(df)
            torch.cuda.synchronize()
            fit_times.append(time.perf_counter() - t)
            launches.append(k1.hist_cuda.launches)
    finally:
        restore()
    if launches[0] == 0 or len(set(launches)) != 1 or plain_calls[0]:
        fail(f"phase 14: K1 launches per chain fit {launches}, plain "
             f"histogram calls {plain_calls[0]}: expected the same nonzero "
             "count and no plain call")
    t = time.perf_counter()
    scored = chain.transform(df)
    torch.cuda.synchronize()
    chain_tr_s = time.perf_counter() - t
    auc = float(ComputeModelStatistics(labelCol="label")
                .transform(scored)["AUC"][0])
    print(f"phase 14: chain fit {', '.join(f'{s:.3f}' for s in fit_times)} "
          f"s (CleanMissingData, Featurize, LightGBMClassifier "
          f"{args.iterations} iterations, 31 leaves, 255 bins, through "
          f"Pipeline.fit), K1 launches per fit {launches[0]}, plain "
          f"histogram calls 0; transform {chain_tr_s:.3f} s; AUC {auc:.6f}")

    # (d) a direct fit on the numpy-assembled vector column
    t = time.perf_counter()
    direct = LightGBMClassifier(**gbdt).fit(DataFrame(
        {"features": want, "label": cols["label"]}))
    torch.cuda.synchronize()
    direct_s = time.perf_counter() - t
    stages_s = clean_fit_s + clean_tr_s + feat_fit_s + feat_tr_s
    print(f"phase 14: where the chain fit's {fit_times[-1]:.3f} s go: the "
          f"stages' fits and transforms {stages_s:.3f} s (host string "
          f"encodings {host_s:.3f} s, Featurize's host level sets in its "
          f"{feat_fit_s:.3f} s fit), the GBDT fit alone on the assembled "
          f"vectors {direct_s:.3f} s, the rest "
          f"{fit_times[-1] - stages_s - direct_s:.3f} s")
    direct_auc = float(ComputeModelStatistics(labelCol="label").transform(
        direct.transform(DataFrame({"features": want,
                                    "label": cols["label"]})))["AUC"][0])
    a = chain.getStages()[-1].booster.arrays
    b = direct.booster.arrays
    root = (int(a["feature"][0, 0]), float(a["threshold"][0, 0]))
    direct_root = (int(b["feature"][0, 0]), float(b["threshold"][0, 0]))
    print(f"phase 14: direct fit on the numpy assembly AUC "
          f"{direct_auc:.6f} (|diff| {abs(direct_auc - auc):.2e}); tree 0 "
          f"root {root} vs {direct_root}")
    if abs(direct_auc - auc) > CHAIN_AUC_ATOL or root != direct_root:
        fail(f"phase 14: chain AUC {auc} / root {root} against the direct "
             f"fit's {direct_auc} / {direct_root}")
    if not 0.75 < auc <= 1.0:
        fail(f"phase 14: AUC {auc} outside (0.75, 1]")
    return launches[0]


def word2vec_phase(torch, dev) -> None:
    """Phase 15: Word2Vec on the card over a planted-group corpus."""
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.featurize import Word2Vec

    rng = np.random.default_rng(15)
    words = np.asarray([f"g{g}w{w}" for g in range(W2V_GROUPS)
                        for w in range(W2V_GROUP_WORDS)], object)
    group = rng.integers(0, W2V_GROUPS, W2V_SENTENCES)
    ids = group[:, None] * W2V_GROUP_WORDS + rng.integers(
        0, W2V_GROUP_WORDS, (W2V_SENTENCES, W2V_LEN))
    docs = np.empty(W2V_SENTENCES, object)
    docs[:] = [list(row) for row in words[ids]]
    df = DataFrame({"tokens": docs})
    t = time.perf_counter()
    model = Word2Vec(**W2V_KW).fit(df)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    losses, secs = model.epoch_losses, model.epoch_seconds
    pairs_s = model.pairs_per_epoch * len(secs) / sum(secs)
    print(f"phase 15: Word2Vec {len(model.get('vocabulary')):,} words, "
          f"{ids.size:,} tokens, {model.pairs_per_epoch:,} pairs an epoch; "
          f"fit {fit_s:.3f} s, epochs "
          f"{', '.join(f'{s:.3f}' for s in secs)} s ({pairs_s:,.0f} "
          f"pairs/s), losses {', '.join(f'{x:.2f}' for x in losses)}")
    if not (np.isfinite(losses).all()
            and all(b < a for a, b in zip(losses, losses[1:]))):
        fail(f"phase 15: epoch losses {losses} are not finite and falling")
    vocab = model.get("vocabulary")
    t = time.perf_counter()
    hits = sum(model.findSynonyms(w, 1)[0][0].split("w")[0]
               == w.split("w")[0] for w in vocab)
    syn_s = time.perf_counter() - t
    share = hits / len(vocab)
    print(f"phase 15: nearest neighbour in the word's own group for "
          f"{share:.1%} of words (limit {W2V_QUALITY_MIN:.0%}; "
          f"findSynonyms on the card {syn_s / len(vocab) * 1e3:.3f} ms a "
          "word)")
    if share < W2V_QUALITY_MIN:
        fail(f"phase 15: only {share:.1%} of nearest neighbours lie in "
             "the word's group")
    card = model.transform(df)["features"]
    model.setDevice("cpu")
    cpu = model.transform(df)["features"]
    err = float(np.abs(card - cpu).max())
    print(f"phase 15: transform on the card against device='cpu' max "
          f"|diff| {err:.2e} (limit {W2V_TRANSFORM_ATOL})")
    if card.shape != (W2V_SENTENCES, W2V_KW["vectorSize"]) or \
            not np.isfinite(card).all() or err > W2V_TRANSFORM_ATOL:
        fail(f"phase 15: transform {card.shape}, max |diff| {err}")


def featurize_phases(torch, k1, dev, args) -> int:
    """Phases 14-15. Returns K1's launches per chain fit."""
    with Phase("phase 14"):
        launches = featurize_chain_phase(torch, k1, args)
    with Phase("phase 15"):
        word2vec_phase(torch, dev)
    return launches


# ------------------------------------------------------ GBDT breadth slice
MC_CLASSES = 7                # Covertype's class count
MC_RUNS = 2                   # timed multiclass fits in phase 16
SPLIT_RTOL = 1e-3             # kernel fit against the plain-histogram fit
BREADTH_MODES = {             # phase 18: the binary cell's other modes
    "bagging+ff": dict(baggingFraction=0.8, baggingFreq=1,
                       featureFraction=0.8),
    "goss": dict(boostingType="goss"),
    "dart+ff": dict(boostingType="dart", featureFraction=0.8),
    "rf": dict(boostingType="rf", baggingFraction=0.8, baggingFreq=1),
    "pos_bagging": dict(posBaggingFraction=0.5, baggingFreq=1),
}


def higgs_like_target(rows: int):
    """``higgs_like``'s features and its margin plus its noise draw (the
    same seed-7 stream) as a continuous target; ``t > 0`` is its label."""
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(rows, 28)).astype(np.float32)
    margin = feats[:, :4].sum(1) + feats[:, 4] * feats[:, 5]
    return feats, (margin + rng.normal(size=rows)).astype(np.float32)


def fit_with_result(torch, est, df):
    """``est.fit(df)`` ending in a synchronize; returns (model, the
    trainer's ``TrainResult``, seconds). The result is read through the
    estimators module's ``train``, since models keep no ``evals``."""
    import mmlspark_torch.lightgbm.estimators as est_mod
    seen = {}
    train = est_mod.train

    def spy(*a, **kw):
        seen["r"] = train(*a, **kw)
        return seen["r"]

    est_mod.train = spy
    try:
        t0 = time.perf_counter()
        model = est.fit(df)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        est_mod.train = train
    return model, seen["r"], secs


def counting_plain(k1):
    """Count the plain histogram's calls through the switch that reaches
    it; returns (calls [n], restore)."""
    calls = [0]
    hist_torch = k1.hist_torch

    def counted(*a, **kw):
        calls[0] += 1
        return hist_torch(*a, **kw)

    k1.hist_torch = counted
    return calls, lambda: setattr(k1, "hist_torch", hist_torch)


def root_splits(booster, trees):
    """Each tree's root as (feature, threshold), or (feature, left set of
    category ids) where the root splits on a category set."""
    a = booster.arrays
    out = []
    for t in trees:
        if "cat_flag" in a and a["cat_flag"][t, 0]:
            out.append((int(a["feature"][t, 0]), tuple(
                np.flatnonzero(a["cat_left"][t, 0, 1:]).tolist())))
        else:
            out.append((int(a["feature"][t, 0]),
                        float(a["threshold"][t, 0])))
    return out


def kernel_against_plain(torch, k1, phase, make, df, iters, metric):
    """A short fit through K1 and the same fit with the plain histogram:
    the same iteration-0 root splits and ``metric(model, result)`` within
    SPLIT_RTOL relative. Returns the kernel fit's metric."""
    kern = make(iters)
    plain = make(iters)
    plain._hist_impl = "torch"
    k1.hist_cuda.launches = 0
    m_k, r_k, _ = fit_with_result(torch, kern, df)
    if k1.hist_cuda.launches == 0:
        fail(f"{phase}: the kernel fit launched K1 0 times")
    k1.hist_cuda.launches = 0
    m_p, r_p, _ = fit_with_result(torch, plain, df)
    if k1.hist_cuda.launches != 0:
        fail(f"{phase}: the plain-histogram fit launched K1")
    K = m_k.booster.num_class
    roots_k = root_splits(m_k.booster, range(K))
    roots_p = root_splits(m_p.booster, range(K))
    v_k, v_p = metric(m_k, r_k), metric(m_p, r_p)
    rel = abs(v_k - v_p) / max(abs(v_p), 1e-30)
    print(f"{phase}: {iters}-iteration kernel fit against the plain "
          f"histogram: iteration-0 root splits {roots_k} vs {roots_p}; "
          f"metric {v_k:.6f} vs {v_p:.6f} ({rel:.2e} relative, limit "
          f"{SPLIT_RTOL})")
    if roots_k != roots_p or rel > SPLIT_RTOL:
        fail(f"{phase}: the kernel fit and the plain-histogram fit part "
             "ways")
    return v_k


def train_metric(result, name):
    return [e[name] for e in result.evals if e.get("dataset") == "train"]


def multiclass_phase(torch, k1, feats, t, args) -> int:
    """Phase 16: a 7-class fit through K1 (K trees an iteration). Returns
    K1's launches per fit."""
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.lightgbm import LightGBMClassifier

    n, iters = len(t), args.iterations
    cuts = np.quantile(t, np.arange(1, MC_CLASSES) / MC_CLASSES)
    classes = np.digitize(t, cuts).astype(np.float32)
    counts = np.bincount(classes.astype(int), minlength=MC_CLASSES)
    df = DataFrame({"features": feats, "label": classes})
    print(f"phase 16: {n:,} rows x 28, {MC_CLASSES} classes from the "
          f"target's quantiles ({counts.min():,}-{counts.max():,} rows a "
          f"class); multiclass, {iters} iterations, 31 leaves, 255 bins, "
          "lr 0.1")

    def make(it):
        return LightGBMClassifier(objective="multiclass", numIterations=it,
                                  numLeaves=31, maxBin=255,
                                  learningRate=0.1,
                                  isProvideTrainingMetric=True)

    # (b) the kernel against the plain histogram (the first is the warm-up)
    kernel_against_plain(
        torch, k1, "phase 16", make, df, 2,
        lambda m, r: train_metric(r, "multi_logloss")[-1])

    # (a) timed fits: the same nonzero K1 launches, no plain call
    calls, restore = counting_plain(k1)
    times, launches = [], []
    try:
        for _ in range(MC_RUNS):
            k1.hist_cuda.launches = 0
            model, result, secs = fit_with_result(torch, make(iters), df)
            times.append(secs)
            launches.append(k1.hist_cuda.launches)
    finally:
        restore()
    trees = model.booster.num_trees
    if launches[0] == 0 or len(set(launches)) != 1 or calls[0]:
        fail(f"phase 16: K1 launches per fit {launches}, plain calls "
             f"{calls[0]}: expected the same nonzero count and none")
    fit_s = min(times)
    # K1's device time over one iteration's K trees: the profiler takes
    # minutes to trace a whole 140-tree fit (~700,000 kernels)
    k1.hist_cuda.launches = 0
    k1_dev = device_ms(torch, lambda: make(1).fit(df),
                       ("hist_partial", "hist_reduce"), runs=1, warm=False)
    k1_ms = k1_dev["hist_partial"] + k1_dev["hist_reduce"]
    per_launch = k1_ms / max(k1.hist_cuda.launches, 1)
    print(f"phase 16: fit {', '.join(f'{x:.3f}' for x in times)} s "
          f"({n * iters / fit_s:,.0f} rows*iterations/s), {trees} trees; "
          f"K1 launches per fit {launches[0]} ({launches[0] / trees:.2f} a "
          f"tree), plain histogram calls 0; K1 device time over a "
          f"1-iteration fit ({MC_CLASSES} trees, {k1.hist_cuda.launches} "
          f"launches, torch.profiler) {k1_ms:.3f} ms "
          f"({k1_dev['hist_partial']:.3f} partial + "
          f"{k1_dev['hist_reduce']:.3f} reduce), {per_launch:.4f} ms a "
          f"launch, so ~{per_launch * launches[0]:.1f} ms over a fit's "
          f"{launches[0]} launches")

    model.transform(df)                           # warm-up transform
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scored = model.transform(df)
    tr_s = time.perf_counter() - t0
    prob = np.asarray(scored["probability"])
    ll = train_metric(result, "multi_logloss")
    acc = float((np.asarray(scored["prediction"]) == classes).mean())
    print(f"phase 16: transform {tr_s:.3f} s ({n / tr_s:,.0f} rows/s); "
          f"training multi_logloss at iterations 1, 10, {iters}: "
          f"{ll[0]:.6f}, {ll[min(9, iters - 1)]:.6f}, {ll[-1]:.6f}; "
          f"accuracy {acc:.6f} (chance {1 / MC_CLASSES:.4f})")
    # (c) probabilities sum to 1; (d) the card's raw scores against the
    # CPU's; (e) the loss falls every iteration; (f) twice chance
    if prob.shape != (n, MC_CLASSES) or not np.isfinite(prob).all() or \
            np.abs(prob.sum(1) - 1.0).max() > 1e-5:
        fail(f"phase 16: probabilities of shape {prob.shape}, sums off "
             f"by {np.abs(prob.sum(1) - 1.0).max():.3g}")
    small = feats[:2000]
    diff = np.abs(model.booster.raw_scores(small, device="cuda")
                  - model.booster.raw_scores(small, device="cpu")).max()
    if diff > 1e-5:
        fail(f"phase 16: raw scores on the card and the CPU differ by "
             f"{diff:.3g}")
    if len(ll) != iters or not all(b < a for a, b in zip(ll, ll[1:])):
        fail(f"phase 16: training multi_logloss does not fall every "
             f"iteration: {ll}")
    if acc < 2.0 / MC_CLASSES:
        fail(f"phase 16: accuracy {acc} under twice chance")
    return launches[0]


def rmse(model, x, y) -> float:
    from mmlspark_torch.core import DataFrame
    pred = np.asarray(model.transform(DataFrame({"features": x}))[
        "prediction"], np.float64)
    return float(np.sqrt(np.mean((pred - y) ** 2)))


def regressor_phase(torch, k1, feats, t, args) -> None:
    """Phase 17: the regressor, two more objectives, validation rows and
    early stopping."""
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.lightgbm import LightGBMRegressor

    n, iters = len(t), args.iterations
    std = float(t.std())
    df = DataFrame({"features": feats, "label": t})

    def make(it, **kw):
        return LightGBMRegressor(numIterations=it, numLeaves=31,
                                 maxBin=255, learningRate=0.1, **kw)

    make(iters).fit(df)                           # warm-up fit
    torch.cuda.synchronize()
    model, _, fit_s = fit_with_result(torch, make(iters), df)
    model.transform(df)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.transform(df)
    tr_s = time.perf_counter() - t0
    err = rmse(model, feats, t)
    print(f"phase 17: regression fit {fit_s:.3f} s "
          f"({n * iters / fit_s:,.0f} rows*iterations/s), RMSE {err:.6f} "
          f"(target std {std:.6f}), transform {tr_s:.3f} s "
          f"({n / tr_s:,.0f} rows/s)")
    for objective in ("huber", "regression_l1"):
        m, _, secs = fit_with_result(torch, make(iters, objective=objective),
                                     df)
        e = rmse(m, feats, t)
        print(f"phase 17: {objective} fit {secs:.3f} s, RMSE {e:.6f}")
        if not np.isfinite(e) or e >= std:
            fail(f"phase 17: {objective} RMSE {e} not below the target's "
                 f"std {std}")
    if not np.isfinite(err) or err >= std:
        fail(f"phase 17: RMSE {err} not below the target's std {std}")

    # early stopping: the last 10 % of rows are validation rows whose
    # targets are shuffled, so their RMSE cannot improve after the init
    flag = np.arange(n) >= n - n // 10
    shuffled = t.copy()
    shuffled[flag] = np.random.default_rng(17).permutation(t[flag])
    vdf = DataFrame({"features": feats, "label": shuffled, "val": flag})
    es, res, secs = fit_with_result(
        torch, make(50, earlyStoppingRound=3, validationIndicatorCol="val"),
        vdf)
    best = es.booster.best_iteration
    last = res.evals[-1]
    host = float(np.sqrt(np.mean((es.booster.raw_scores(
        feats[flag], num_iteration=last["iteration"] + 1,
        device="cuda").astype(np.float64) - shuffled[flag]) ** 2)))
    print(f"phase 17: early stopping fit {secs:.3f} s: stopped after "
          f"iteration {last['iteration']}, best_iteration {best}, "
          f"{es.booster.num_iterations} iterations trained; last "
          f"validation RMSE {last['rmse']:.6f}, host recomputation "
          f"{host:.6f}")
    if last["iteration"] != best + 3 or last["iteration"] >= 49:
        fail(f"phase 17: early stopping ended at {last['iteration']} with "
             f"best_iteration {best}")
    used = es.booster._effective_trees()
    if used != best + 1:
        fail(f"phase 17: the booster scores {used} iterations, expected "
             f"best_iteration + 1 = {best + 1}")
    if abs(last["rmse"] - host) > 1e-5 * host:
        fail(f"phase 17: validation RMSE {last['rmse']} against the host's "
             f"{host}")

    # the kernel against the plain histogram
    kernel_against_plain(torch, k1, "phase 17", lambda it: make(it), df, 3,
                         lambda m, r: rmse(m, feats, t))


def modes_phase(torch, k1, feats, labels, args) -> dict:
    """Phase 18: sampling and boosting modes on the binary GBDT cell.
    Returns K1's launches per fit by mode."""
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.lightgbm import LightGBMClassifier
    import mmlspark_torch.lightgbm.trainer as trainer
    from mmlspark_torch.train import ComputeModelStatistics

    n, iters = len(labels), args.iterations
    df = DataFrame({"features": feats, "label": labels})

    def make(it, **kw):
        return LightGBMClassifier(numIterations=it, numLeaves=31,
                                  maxBin=255, learningRate=0.1, **kw)

    def auc(model):
        return float(ComputeModelStatistics(labelCol="label").transform(
            model.transform(df))["AUC"][0])

    make(iters).fit(df)                           # warm-up: phase 3's fit
    torch.cuda.synchronize()
    launches = {}
    for mode, kw in BREADTH_MODES.items():
        trainer._debug_capture = {} if mode == "goss" else None
        try:
            k1.hist_cuda.launches = 0
            model, _, secs = fit_with_result(torch, make(iters, **kw), df)
            launches[mode] = k1.hist_cuda.launches
            mask = None if trainer._debug_capture is None else \
                trainer._debug_capture["goss_mask0"]
        finally:
            trainer._debug_capture = None
        a = auc(model)
        print(f"phase 18: {mode} ({kw}) fit {secs:.3f} s, K1 launches "
              f"{launches[mode]}, AUC {a:.6f}")
        if not 0.75 < a <= 1.0 or launches[mode] == 0:
            fail(f"phase 18: {mode} AUC {a} outside (0.75, 1] or no K1 "
                 "launch")
        if mask is not None:
            top_n, other_n = int(0.2 * n), int(0.1 * n)
            amp = torch.tensor((1.0 - 0.2) / 0.1, dtype=torch.float32)
            ones = int((mask == 1.0).sum())
            amplified = int((mask == amp.to(mask.device)).sum())
            zeros = int((mask == 0).sum())
            print(f"phase 18: goss iteration-0 mask: {ones:,} rows at 1, "
                  f"{amplified:,} at {float(amp):g}, {zeros:,} at 0 "
                  f"(top_n {top_n:,}, other_n {other_n:,})")
            if (ones, amplified, zeros) != (top_n, other_n,
                                            n - top_n - other_n):
                fail("phase 18: the GOSS mask breaks its invariants")
        kernel_against_plain(torch, k1, f"phase 18 {mode}",
                             lambda it, kw=kw: make(it, **kw), df, 3,
                             lambda m, r: auc(m))
    return launches


def breadth_phases(torch, k1, args) -> dict:
    """Phases 16-18. Returns K1's launch counts for the kernels line."""
    feats, t = higgs_like_target(args.rows)
    with Phase("phase 16"):
        mc = multiclass_phase(torch, k1, feats, t, args)
    with Phase("phase 17"):
        regressor_phase(torch, k1, feats, t, args)
    with Phase("phase 18"):
        modes = modes_phase(torch, k1, feats, (t > 0).astype(np.float32),
                            args)
    return {"multiclass_launches": mc, "mode_launches": modes}


# ------------------------------------------------ GBDT breadth, entries 4-6
CAT_LEVELS = (12, 200)        # phase 19's categorical slots
CAT_RUNS = 2                  # timed categorical fits
CAPPED_SLOT, CAPPED_BINS = 0, 16   # phase 19's maxBinByFeature fit
CARD_CPU_RAW_ATOL = 1e-5      # the card's raw scores against the CPU's
ROUND_TRIP_ATOL = 1e-6        # a text-format round trip on one device
SPARSE_ROWS, SPARSE_WIDTH, SPARSE_F = 200_000, 32, 10_000
SPARSE_ITERS = 10
SPARSE_CHECK_ROWS = 20_000    # the card fit held against device="cpu"
SPARSE_CHECK_ITERS = 3        # ... over this many iterations
RANK_QUERIES, RANK_DOCS, RANK_F, RANK_ITERS = 1000, 100, 32, 10
LAMBDA_ATOL = 1e-5            # iteration-0 lambdarank gradients, card/CPU
SHAP_ROWS, SHAP_ATOL = 256, 1e-4


def categorical_frame(rows: int):
    """Phase 3's features and label draws (seed 7) plus two categorical
    slots (seed 19) of ``CAT_LEVELS`` levels; the label's margin gains 1.0
    on a seeded half of the 200 levels (no threshold separates it)."""
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(rows, 28)).astype(np.float32)
    margin = feats[:, :4].sum(1) + feats[:, 4] * feats[:, 5]
    noise = rng.normal(size=rows)
    crng = np.random.default_rng(19)
    cats = np.stack([crng.integers(0, k, size=rows) for k in CAT_LEVELS],
                    1).astype(np.float32)
    good = crng.permutation(CAT_LEVELS[1])[:CAT_LEVELS[1] // 2]
    margin = margin + np.isin(cats[:, 1], good)
    labels = (margin + noise > 0).astype(np.float32)
    return np.concatenate([feats, cats], 1), labels, good


def auc_of(model, df) -> float:
    from mmlspark_torch.train import ComputeModelStatistics
    return float(ComputeModelStatistics(labelCol="label").transform(
        model.transform(df))["AUC"][0])


def categorical_phase(torch, k1, args):
    """Phase 19: categorical slots and ``maxBinByFeature`` through K1.
    Returns (K1 launches per fit, the fitted model, its rows)."""
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.lightgbm import (LightGBMClassificationModel,
                                         LightGBMClassifier)
    from mmlspark_torch.lightgbm.trainer import (TrainConfig,
                                                 _dense_boundaries)

    n, iters = args.rows, args.iterations
    x, labels, good = categorical_frame(n)
    F = x.shape[1]
    cat_slots = [F - 2, F - 1]
    df = DataFrame({"features": x, "label": labels})
    print(f"phase 19: {n:,} rows x {F} (28 numeric, categorical slots "
          f"{cat_slots} of {CAT_LEVELS} levels; +1.0 margin on "
          f"{len(good)} seeded levels of slot {cat_slots[1]}); binary, "
          f"{iters} iterations, 31 leaves, 255 bins, lr 0.1")

    def make(it, **kw):
        kw.setdefault("categoricalSlotIndexes", cat_slots)
        return LightGBMClassifier(numIterations=it, numLeaves=31,
                                  maxBin=255, learningRate=0.1, **kw)

    # the kernel against the plain histogram (the first fit warms up)
    kernel_against_plain(torch, k1, "phase 19", make, df, 3,
                         lambda m, r: auc_of(m, df))

    calls, restore = counting_plain(k1)
    times, launches = [], []
    try:
        for _ in range(CAT_RUNS):
            k1.hist_cuda.launches = 0
            model, _, secs = fit_with_result(torch, make(iters), df)
            times.append(secs)
            launches.append(k1.hist_cuda.launches)
    finally:
        restore()
    if launches[0] == 0 or len(set(launches)) != 1 or calls[0]:
        fail(f"phase 19: K1 launches per fit {launches}, plain calls "
             f"{calls[0]}: expected the same nonzero count and none")
    a = model.booster.arrays
    n_cat = int(a["cat_flag"].sum()) if "cat_flag" in a else 0
    sizes = a["cat_left"][a["cat_flag"]].sum(-1) if n_cat else np.zeros(1)
    auc = auc_of(model, df)
    ordinal = auc_of(LightGBMClassifier(
        numIterations=iters, numLeaves=31, maxBin=255,
        learningRate=0.1).fit(df), df)
    fit_s = min(times)
    print(f"phase 19: fit {', '.join(f'{t:.3f}' for t in times)} s "
          f"({n * iters / fit_s:,.0f} rows*iterations/s); K1 launches per "
          f"fit {launches[0]}, plain histogram calls 0; {n_cat} set splits "
          f"of {int((~a['is_leaf'] & (a['left'] >= 0)).sum())} (left sets "
          f"of {int(sizes.min())}-{int(sizes.max())} categories); AUC "
          f"{auc:.6f}, ordinal fit {ordinal:.6f}")
    if n_cat == 0:
        fail("phase 19: no tree split on a category set")
    if not auc > ordinal:
        fail(f"phase 19: set-split AUC {auc} not above the ordinal fit's "
             f"{ordinal}")

    # the text format: saved, loaded, scored on the card and the CPU
    text = model.get_native_model_string()
    loaded = LightGBMClassificationModel.loadNativeModelFromString(text)
    small = x[:20_000]
    raw = model.booster.raw_scores(small, device="cuda")
    raw_loaded = loaded.booster.raw_scores(small, device="cuda")
    raw_cpu = model.booster.raw_scores(small, device="cpu")
    rt = float(np.abs(raw_loaded - raw).max())
    cc = float(np.abs(raw_cpu - raw).max())
    late = loaded.booster.arrays["cat_left"]
    loaded.booster.arrays["cat_left"] = np.roll(late, 1, axis=-1)
    loaded.booster._dev_cache = None
    fault = float(np.abs(loaded.booster.raw_scores(
        small, device="cuda") - raw).max())
    print(f"phase 19: text round trip max |Δraw| {rt:.3g} on the card "
          f"(limit {ROUND_TRIP_ATOL}), card against CPU {cc:.3g} (limit "
          f"{CARD_CPU_RAW_ATOL}); planted fault (the loaded bitset read "
          f"one bin late) {fault:.3g}")
    if rt > ROUND_TRIP_ATOL or cc > CARD_CPU_RAW_ATOL:
        fail("phase 19: the categorical model does not survive the text "
             "format or disagrees between the card and the CPU")
    if fault <= ROUND_TRIP_ATOL:
        fail("phase 19: the planted bitset fault passed the round-trip "
             "hold")

    # unseen (250), negative and non-integer ids route as missing: right
    probe = x[:4096].copy()
    ref = probe.copy()
    ref[:, cat_slots] = np.nan
    want = model.booster.predict_leaf(ref, device="cuda")
    for bad in (250.0, -1.0, 3.5):
        probe[:, cat_slots] = bad
        got = model.booster.predict_leaf(probe, device="cuda")
        if not np.array_equal(got, want):
            fail(f"phase 19: category id {bad} does not route as a "
                 "missing one (right)")
    print("phase 19: ids 250 (unseen), -1 and 3.5 route as missing ones "
          "at every node")

    # maxBinByFeature: the capped slot splits at or below its 15th cut
    budgets = [0] * F
    budgets[CAPPED_SLOT] = CAPPED_BINS
    capped_est = make(iters, maxBinByFeature=budgets)
    capped, _, secs = fit_with_result(torch, capped_est, df)
    # the boundaries this fit binned with (its seed's sample of rows)
    bounds = _dense_boundaries(x, TrainConfig(
        max_bin=255, seed=capped_est.getSeed(),
        bin_sample_count=capped_est.getBinSampleCount(),
        categorical_features=tuple(cat_slots),
        max_bin_by_feature=tuple(budgets)), F)
    if np.isfinite(bounds[CAPPED_SLOT, CAPPED_BINS - 1:]).any():
        fail(f"phase 19: slot {CAPPED_SLOT} keeps cuts past its budget")
    cut = float(bounds[CAPPED_SLOT, CAPPED_BINS - 2])
    ca = capped.booster.arrays
    on_slot = ~ca["is_leaf"] & (ca["left"] >= 0) & \
        (ca["feature"] == CAPPED_SLOT)
    thr = ca["threshold"][on_slot]
    print(f"phase 19: maxBinByFeature[{CAPPED_SLOT}]={CAPPED_BINS} fit "
          f"{secs:.3f} s: {int(on_slot.sum())} splits on slot "
          f"{CAPPED_SLOT}, thresholds at most {thr.max() if thr.size else 0:.6f} "
          f"(its {CAPPED_BINS - 1}th cut {cut:.6f})")
    if thr.size == 0 or thr.max() > cut:
        fail(f"phase 19: slot {CAPPED_SLOT} splits past its "
             f"{CAPPED_BINS - 1}th cut (or never)")
    return launches[0], model, x


def hashed_text(rows: int):
    """``bench.py``'s padded-COO workload: 32 unique indices a row over
    10,000 features (seed 13), labels the signed margin's sign."""
    rng = np.random.default_rng(13)
    idx = np.stack([rng.choice(SPARSE_F, size=SPARSE_WIDTH, replace=False)
                    for _ in range(512)])
    idx = np.tile(idx, (rows // 512 + 1, 1))[:rows].astype(np.int32)
    val = rng.normal(size=(rows, SPARSE_WIDTH)).astype(np.float32)
    w_sig = rng.normal(size=SPARSE_F).astype(np.float32)
    y = ((val * w_sig[idx]).sum(1) > 0).astype(np.float32)
    return idx, val, y


def top_kernels(torch, fn, k=6):
    """The ``k`` kernels with the most device time over one call of
    ``fn`` (``torch.profiler``), as (name, ms, calls)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])[:k]


def sparse_phase(torch, k1, args) -> None:
    """Phase 20: the padded-COO path (no kernel of the port: its histogram
    is ``index_add_``, as the JAX package's is an XLA segment-sum)."""
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.lightgbm import Booster, LightGBMClassifier
    from mmlspark_torch.lightgbm.sparse import SparseData

    rows = min(args.rows, SPARSE_ROWS)
    idx, val, y = hashed_text(rows)
    df = DataFrame({"features_indices": idx, "features_values": val,
                    "label": y})
    print(f"phase 20: {rows:,} rows of {SPARSE_WIDTH} entries over "
          f"{SPARSE_F:,} features (padded-COO); binary, {SPARSE_ITERS} "
          "iterations, 31 leaves")

    def make(it, **kw):
        return LightGBMClassifier(numIterations=it, numLeaves=31,
                                  learningRate=0.1, **kw)

    # a traced 1-iteration fit, which also warms the sparse path's
    # kernels up (phase 19's fits warmed the rest)
    top = top_kernels(torch, lambda: make(1).fit(df))
    hist_ms = sum(ms for name, ms, _ in top if "indexFunc" in name)
    k1.hist_cuda.launches = 0
    model, result, secs = fit_with_result(torch, make(SPARSE_ITERS), df)
    if k1.hist_cuda.launches:
        fail(f"phase 20: the sparse fit launched K1 "
             f"{k1.hist_cuda.launches} times")
    auc = auc_of(model, df)
    split = result.seconds
    print(f"phase 20: fit {secs:.3f} s ({rows * SPARSE_ITERS / secs:,.0f} "
          f"rows*iterations/s; host binning {split['binning']:.3f} s, "
          f"boosting {split['boosting']:.3f} s), AUC {auc:.6f}, K1 "
          "launches 0; a 1-iteration fit's top device kernels "
          "(torch.profiler): "
          + "; ".join(f"{name[:60]} {ms:.3f} ms x{cnt}"
                      for name, ms, cnt in top)
          + f"; the histogram's index_add_ (indexFunc) {hist_ms:.3f} ms")

    # the card against the CPU at 20,000 rows
    m = min(rows, SPARSE_CHECK_ROWS)
    small = DataFrame({"features_indices": idx[:m],
                       "features_values": val[:m], "label": y[:m]})
    card = make(SPARSE_CHECK_ITERS).fit(small)
    cpu = make(SPARSE_CHECK_ITERS, device="cpu").fit(small)
    r_card, r_cpu = root_splits(card.booster, [0]), root_splits(
        cpu.booster, [0])
    a_card = auc_of(card, small)
    a_cpu = auc_of(cpu, small)
    print(f"phase 20: {m:,}-row {SPARSE_CHECK_ITERS}-iteration fit on the "
          "card against device='cpu': "
          f"tree-0 root {r_card} vs {r_cpu}, AUC {a_card:.6f} vs "
          f"{a_cpu:.6f}")
    if r_card != r_cpu or abs(a_card - a_cpu) > SPLIT_RTOL:
        fail("phase 20: the card's sparse fit and the CPU's part ways")

    # COO scoring against the densified rows; the text format
    sd = SparseData(idx[:1000], val[:1000], SPARSE_F)
    dense = np.zeros((1000, SPARSE_F), np.float32)
    np.put_along_axis(dense, idx[:1000].astype(np.int64), val[:1000], 1)
    coo = model.booster.raw_scores(sd, device="cuda")
    den = model.booster.raw_scores(dense, device="cuda")
    back = Booster.load_native(model.get_native_model_string())
    rt = back.raw_scores(sd, device="cuda")
    d1, d2 = float(np.abs(coo - den).max()), float(np.abs(rt - coo).max())
    print(f"phase 20: 1,000 rows scored from COO against densified "
          f"{d1:.3g}, after a text round trip {d2:.3g} (limit "
          f"{ROUND_TRIP_ATOL})")
    if d1 > ROUND_TRIP_ATOL or d2 > ROUND_TRIP_ATOL:
        fail("phase 20: COO scoring or the text round trip disagrees")


def mslr_like():
    """``bench.py``'s ranker workload: 1,000 queries of 100 documents, 32
    features, graded 0-4 relevance from a latent utility (seed 5)."""
    n = RANK_QUERIES * RANK_DOCS
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, RANK_F)).astype(np.float32)
    w_true = rng.normal(size=RANK_F).astype(np.float32)
    util = x @ w_true + rng.normal(scale=2.0, size=n).astype(np.float32)
    rel = np.digitize(util, np.quantile(util, [0.5, 0.75, 0.9, 0.97])) \
        .astype(np.float32)
    return x, rel, np.repeat(np.arange(RANK_QUERIES), RANK_DOCS)


def ranker_phase(torch, k1, cat_model, cat_x) -> int:
    """Phase 21: ``LightGBMRanker`` through K1, then SHAP values of phase
    19's model. Returns K1's launches per ranker fit."""
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.lightgbm import LightGBMRanker
    from mmlspark_torch.lightgbm.ranker_objective import (
        build_group_index, make_lambdarank_grad_hess, ndcg_at_k)
    from mmlspark_torch.lightgbm.shap import booster_shap_values

    x, rel, qid = mslr_like()
    n = len(rel)
    df = DataFrame({"features": x, "label": rel, "query": qid})
    print(f"phase 21: {RANK_QUERIES:,} queries x {RANK_DOCS} documents x "
          f"{RANK_F} features, relevance 0-4; lambdarank, {RANK_ITERS} "
          "iterations, 31 leaves")

    def make(it):
        return LightGBMRanker(groupCol="query", numIterations=it,
                              numLeaves=31, seed=0)

    kernel_against_plain(torch, k1, "phase 21", make, df, 3,
                         lambda m, r: m.evaluate_ndcg(df, k=10))
    calls, restore = counting_plain(k1)
    try:
        k1.hist_cuda.launches = 0
        model, _, secs = fit_with_result(torch, make(RANK_ITERS), df)
        launches = k1.hist_cuda.launches
    finally:
        restore()
    if launches == 0 or calls[0]:
        fail(f"phase 21: K1 launches {launches}, plain calls {calls[0]}")
    ndcg = {k: model.evaluate_ndcg(df, k=k) for k in (1, 3, 5, 10)}
    rand = ndcg_at_k(np.random.default_rng(21).random(n), rel, qid, k=10)
    print(f"phase 21: fit {secs:.3f} s ({n * RANK_ITERS / secs:,.0f} "
          f"rows*iterations/s), K1 launches {launches}, plain histogram "
          "calls 0; " + ", ".join(f"ndcg@{k} {v:.6f}"
                                  for k, v in ndcg.items())
          + f"; a seeded random scoring's ndcg@10 {rand:.6f}")
    if not ndcg[10] > rand:
        fail("phase 21: ndcg@10 not above a random scoring's")

    # iteration-0 lambdarank gradients (every score ties) card against CPU
    gh = make_lambdarank_grad_hess(rel, build_group_index(qid))
    g_card, h_card = gh(torch.zeros(n, device="cuda"))
    g_cpu, h_cpu = gh(torch.zeros(n))
    dg = float((g_card.cpu() - g_cpu).abs().max())
    dh = float((h_card.cpu() - h_cpu).abs().max())
    print(f"phase 21: iteration-0 lambdarank gradients card against CPU: "
          f"max |Δg| {dg:.3g}, |Δh| {dh:.3g} (limit {LAMBDA_ATOL})")
    if dg > LAMBDA_ATOL or dh > LAMBDA_ATOL:
        fail("phase 21: lambdarank gradients differ between the card and "
             "the CPU")

    # SHAP of phase 19's categorical model: contributions + bias = raw
    rows = cat_x[:SHAP_ROWS]
    t0 = time.perf_counter()
    shap = booster_shap_values(cat_model.booster, rows, rows.shape[1])
    shap_s = time.perf_counter() - t0
    raw = cat_model.booster.raw_scores(rows, device="cuda")
    err = float(np.abs(shap.sum(-1) - raw).max())
    print(f"phase 21: SHAP of {SHAP_ROWS} rows of phase 19's model "
          f"({cat_model.booster.num_trees} trees) {shap_s:.3f} s on the "
          f"host; max |Σ contributions + bias - raw| {err:.3g} (limit "
          f"{SHAP_ATOL})")
    if err > SHAP_ATOL or not np.isfinite(shap).all():
        fail("phase 21: SHAP values do not sum to the raw scores")
    return launches


def breadth2_phases(torch, k1, args) -> dict:
    """Phases 19-21. Returns K1's launch counts for the kernels line."""
    with Phase("phase 19"):
        cat_launches, cat_model, cat_x = categorical_phase(torch, k1, args)
    with Phase("phase 20"):
        sparse_phase(torch, k1, args)
    with Phase("phase 21"):
        rank_launches = ranker_phase(torch, k1, cat_model, cat_x)
    return {"categorical_launches": cat_launches,
            "ranker_launches": rank_launches}


# ------------------------------------------------ GBDT breadth, entries 7-8
CONT_LEAF_ATOL = 1e-5         # phase 22: leaf values of two fits' trees
CONT_SCORE_ATOL = 1e-5        # phase 22: a model's raw scores and its text's
SHARD_RANKS = 2               # phase 23: ranks on the one card (gloo)
SHARD_PROB_ATOL = 5e-3        # tests/test_lightgbm_distributed.py:40-44
SHARD_AUC_ATOL = 0.002        # data parallel against one rank
VOTING_AUC_ATOL = 0.02        # voting against data parallel
VOTING_TOP_K = 6              # tests/test_benchmarks.py:277-278; at the
                              # default 20, 2*topK >= 28 columns: no vote
SHARD_TIMEOUT = 150.0         # seconds the ranks may take in all


def same_trees(a, b, first: int = 0):
    """Whether booster ``a``'s trees equal booster ``b``'s from tree
    ``first`` on in structure (features, thresholds, children, leaves),
    and the largest leaf-value difference."""
    T = a.num_trees
    if b.num_trees - first != T:
        return False, float("inf")
    nn = min(a.arrays["feature"].shape[1], b.arrays["feature"].shape[1])
    arr = {k: (a.arrays[k][:, :nn], b.arrays[k][first:, :nn])
           for k in ("feature", "threshold", "left", "right", "is_leaf",
                     "leaf_value")}
    same = all(np.array_equal(x, y) for k, (x, y) in arr.items()
               if k != "leaf_value") and np.array_equal(
        a.arrays["num_nodes"], b.arrays["num_nodes"][first:])
    x, y = arr["leaf_value"]
    return same, float(np.abs(x - y).max())


def continuation_phase(torch, k1, args) -> int:
    """Phase 22: model continuation on phase 3's rows. Returns K1's
    launches per two-batch fit."""
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.lightgbm import Booster, LightGBMClassifier

    feats, labels = higgs_like(args.rows)
    df = DataFrame({"features": feats, "label": labels})
    parts = df.repartition(2).partitions()
    it = max(args.iterations // 2, 1)
    print(f"phase 22: {args.rows:,} x 28 in 2 batches of "
          f"{len(parts[0]):,} rows, {it} iterations a batch, 31 leaves, "
          "255 bins")

    def make(**kw):
        kw.setdefault("numIterations", it)
        return LightGBMClassifier(numLeaves=31, maxBin=255,
                                  learningRate=0.1, **kw)

    make(numIterations=1).fit(parts[0])              # warm-up
    torch.cuda.synchronize()
    calls, restore = counting_plain(k1)
    fits = {}
    try:
        def run(name, fn):
            k1.hist_cuda.launches = 0
            t0 = time.perf_counter()
            model = fn()
            torch.cuda.synchronize()
            fits[name] = (model, k1.hist_cuda.launches,
                          time.perf_counter() - t0)

        run("numBatches=2", lambda: make(numBatches=2).fit(df))
        run("fit_stream", lambda: make().fit_stream(iter(parts)))
        run("batch 1", lambda: make().fit(parts[0]))
        text1 = fits["batch 1"][0].booster.save_native()
        run("modelString", lambda: make(modelString=text1).fit(parts[1]))
        # batch 1's raw scores on batch 2: the scores the modelString fit
        # starts from, up to the last bits (the text folds the init score
        # into the first tree's leaves)
        init = fits["batch 1"][0].booster.raw_scores(parts[1]["features"],
                                                     device="cuda")
        back = Booster.load_native(text1).raw_scores(parts[1]["features"],
                                                     device="cuda")
        print("phase 22: batch 1's model and its text on batch 2: max "
              f"|Δ raw score| {np.abs(init - back).max():.3g} (limit "
              f"{CONT_SCORE_ATOL})")
        if np.abs(init - back).max() > CONT_SCORE_ATOL:
            fail("phase 22: batch 1's model and its text score batch 2 "
                 f"apart (max |diff| {np.abs(init - back).max():.3g}, "
                 f"limit {CONT_SCORE_ATOL})")
        run("initScoreCol", lambda: make(initScoreCol="s").fit(
            parts[1].with_column("s", init)))
    finally:
        restore()
    for name, (model, launches, secs) in fits.items():
        print(f"phase 22: {name} fit {secs:.3f} s, {model.booster.num_trees}"
              f" trees, K1 launches {launches}")
    per_batch = 31 * it
    want = {"numBatches=2": 2 * per_batch, "fit_stream": 2 * per_batch,
            "batch 1": per_batch, "modelString": per_batch,
            "initScoreCol": per_batch}
    got = {name: f[1] for name, f in fits.items()}
    if got != want or calls[0]:
        fail(f"phase 22: K1 launches {got}, expected {want}; plain "
             f"histogram calls {calls[0]}")
    # K1 adds floats with shared-memory atomics, so two fits on the card
    # differ in the last bits, and the modelString fit starts from its
    # text's scores: the paths are held tree by tree, each model through
    # its text, so that every booster's arrays share one node layout
    text = {name: f[0].get_native_model_string() for name, f in fits.items()}
    ref = Booster.load_native(text["numBatches=2"])
    for name in ("fit_stream", "modelString"):
        same, diff = same_trees(ref, Booster.load_native(text[name]))
        print(f"phase 22: {name} against numBatches=2: trees equal in "
              f"structure {same}, max |Δ leaf value| {diff:.3g} (limit "
              f"{CONT_LEAF_ATOL}), text bit-equal "
              f"{text[name] == text['numBatches=2']}")
        if not same or diff > CONT_LEAF_ATOL:
            fail(f"phase 22: the {name} fit parts ways with numBatches=2")
    cont = Booster.load_native(text["modelString"])
    warm = Booster.load_native(text["initScoreCol"])
    same, diff = same_trees(warm, cont, first=it)
    print(f"phase 22: the initScoreCol fit's {warm.num_trees} trees against "
          f"the modelString continuation's last {it}: equal in structure "
          f"{same}, max |Δ leaf value| {diff:.3g}")
    if not same or diff > CONT_LEAF_ATOL:
        fail("phase 22: the initScoreCol trees differ from the "
             "continuation's")
    auc = auc_of(fits["numBatches=2"][0], df)
    print(f"phase 22: two-batch model AUC {auc:.6f} on all "
          f"{args.rows:,} rows")
    if not 0.75 < auc <= 1.0:
        fail(f"phase 22: AUC {auc} outside (0.75, 1]")
    return got["numBatches=2"]


def shard_rank(rank, world, port, rows, iters, out_dir, device, backend):
    """One rank of phase 23: joins the process group, fits phase 3's rows
    (the whole frame; the rank trains on its block) data and voting
    parallel, and writes its counts, seconds and (rank 0) probabilities.
    On CUDA rank r takes card r modulo the cards there are (all of them
    ``cuda:0`` on a one-card machine)."""
    import pickle
    import torch
    import torch.distributed as dist
    import mmlspark_torch.lightgbm.hist as k1
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.lightgbm import LightGBMClassifier
    from mmlspark_torch.parallel.collectives import allreduce

    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        feats, labels = higgs_like(rows)
        df = DataFrame({"features": feats, "label": labels})

        def make(it, **kw):
            return LightGBMClassifier(
                numIterations=it, numLeaves=31, maxBin=255,
                learningRate=0.1, numShards=world, device=device, **kw)

        make(2).fit(df)                              # warm-up
        out = {}
        for mode, kw in (("data", {}),
                         ("voting", dict(parallelism="voting_parallel",
                                         topK=VOTING_TOP_K))):
            k1.hist_cuda.launches = 0
            calls0, bytes0, secs0 = (allreduce.calls, allreduce.bytes,
                                     allreduce.seconds)
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = make(iters, **kw).fit(df)
            if device == "cuda":
                torch.cuda.synchronize()
            out[mode] = dict(secs=time.perf_counter() - t0,
                             launches=k1.hist_cuda.launches,
                             calls=allreduce.calls - calls0,
                             bytes=allreduce.bytes - bytes0,
                             wait=allreduce.seconds - secs0,
                             text_len=len(model.get_native_model_string()))
            if rank == 0:
                out[mode]["prob"] = np.asarray(model.transform(DataFrame(
                    {"features": feats}))["probability"])[:, 1]
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(torch, world, rows, iters, device="cuda", backend="gloo",
              timeout=SHARD_TIMEOUT) -> list:
    """Phase 23's ranks, spawned; returns each rank's record."""
    import pickle
    import socket
    import tempfile
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.start_processes(shard_rank, args=(world, port, rows, iters,
                                                   d, device, backend),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.perf_counter() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.perf_counter(),
                                           0.1)):
                if time.perf_counter() > deadline:
                    fail(f"phase 23: ranks still running after "
                         f"{timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            fail(f"phase 23: a rank failed: {e}")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        out = []
        for r in range(world):
            with open(f"{d}/rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
    return out


def shards_phase(torch, k1, args, world=SHARD_RANKS, backend="gloo",
                 device="cuda", timeout=SHARD_TIMEOUT) -> dict:
    """Phase 23: ``world`` ranks over ``backend`` (rank r on card r modulo
    the cards there are: all on ``cuda:0`` on a one-card machine) against
    one rank on the same rows. Returns the phase's numbers; ``launches``
    is rank 0's count of K1 launches in its data-parallel fit (0 on the
    CPU, where K1 is not launched)."""
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.lightgbm import LightGBMClassifier
    from mmlspark_torch.lightgbm.engine import comm_elements_per_split
    from mmlspark_torch.lightgbm.trainer import roc_auc

    cuda = device == "cuda"
    rows, iters = args.rows, args.iterations
    print(f"phase 23: {world} ranks on {device} over {backend}, {rows:,} x "
          f"28 ({rows // world:,} rows a rank), {iters} iterations, 31 "
          f"leaves, 255 bins; voting at topK={VOTING_TOP_K}")
    t0 = time.perf_counter()
    ranks = run_ranks(torch, world, rows, iters, device=device,
                      backend=backend, timeout=timeout)
    spawn_s = time.perf_counter() - t0
    feats, labels = higgs_like(rows)
    df = DataFrame({"features": feats, "label": labels})
    single = LightGBMClassifier(numIterations=iters, numLeaves=31,
                                maxBin=255, learningRate=0.1, device=device)
    single.fit(df)                                   # warm (phase 3's fit)
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    model = single.fit(df)
    if cuda:
        torch.cuda.synchronize()
    single_s = time.perf_counter() - t1
    p1 = np.asarray(model.transform(DataFrame({"features": feats}))[
        "probability"])[:, 1]
    auc1 = roc_auc(labels, p1)
    want = 31 * iters if cuda else 0
    B = 256
    out = {"ranks": world, "backend": backend, "rows": rows,
           "iterations": iters, "one_rank_s": single_s,
           "one_rank_auc": auc1, "spawn_to_end_s": spawn_s,
           "launches": ranks[0]["data"]["launches"]}
    for mode in ("data", "voting"):
        for r, rec in enumerate(ranks):
            m = rec[mode]
            print(f"phase 23: {mode} parallel rank {r}: fit "
                  f"{m['secs']:.3f} s, K1 launches {m['launches']}, "
                  f"all_reduce {m['calls']} calls, {m['bytes']:,} B a fit "
                  f"({m['bytes'] / iters:,.0f} B a tree), {m['wait']:.3f} s "
                  "inside them")
            if m["launches"] != want:
                fail(f"phase 23: {mode} rank {r} launched K1 "
                     f"{m['launches']} times, expected {want}")
        per_split = 4 * comm_elements_per_split(
            28, B, VOTING_TOP_K, "voting" if mode == "voting" else "data")
        print(f"phase 23: {mode} parallel moves {per_split:,} B a split "
              "(comm_elements_per_split x 4)")
        p = ranks[0][mode]["prob"]
        out[mode] = {"fit_s": [rec[mode]["secs"] for rec in ranks],
                     "launches": [rec[mode]["launches"] for rec in ranks],
                     "calls": ranks[0][mode]["calls"],
                     "bytes": ranks[0][mode]["bytes"],
                     "inside_s": [rec[mode]["wait"] for rec in ranks],
                     "max_abs_dp": float(np.abs(p - p1).max()),
                     "auc": roc_auc(labels, p)}
    print(f"phase 23: one rank: fit {single_s:.3f} s, AUC {auc1:.6f}; "
          f"spawn to the ranks' end {spawn_s:.1f} s")
    dp, auc_d, auc_v = (out["data"]["max_abs_dp"], out["data"]["auc"],
                        out["voting"]["auc"])
    print(f"phase 23: data parallel against one rank: max |Δp| {dp:.3g} "
          f"(limit {SHARD_PROB_ATOL}), AUC {auc_d:.6f} vs {auc1:.6f} "
          f"(limit {SHARD_AUC_ATOL}); voting AUC {auc_v:.6f} (limit "
          f"{VOTING_AUC_ATOL} of data parallel)")
    if dp > SHARD_PROB_ATOL or abs(auc_d - auc1) > SHARD_AUC_ATOL:
        fail("phase 23: data parallel parts ways with one rank")
    if abs(auc_v - auc_d) > VOTING_AUC_ATOL:
        fail("phase 23: voting parallel parts ways with data parallel")
    return out


def breadth3_phases(torch, k1, args) -> dict:
    """Phases 22-23. Returns K1's launch counts for the kernels line."""
    with Phase("phase 22"):
        cont = continuation_phase(torch, k1, args)
    with Phase("phase 23"):
        shard = shards_phase(torch, k1, args)
    return {"continuation_launches": cont,
            "shard_launches_per_rank": shard["launches"]}


# ------------------------------------------------------ text generation

# phase 24: bert-base-uncased's published config (vocab 30,522, width 768,
# 12 layers of 12 heads, mlp 3,072, 512 learned positions, 2 token types,
# the pooler); seeded weights in the HF state-dict layout
BERT_BASE = dict(vocab=30522, width=768, depth=12, heads=12, mlp_dim=3072,
                 max_len=512, type_vocab=2)
BERT_RUNS = 3                 # warm transforms timed in phase 24 (median)
# phase 24 holds the f32 transform with phase 6's POOLED_LIMITS. In bf16
# the random-init BERT's pooled rows share most of their vector (centred
# median 0.026 against 0.57 raw on the H100, PERF.md §6), so the tokens' bf16
# roundings, which the mean pool keeps at ~1e-3, weigh ~20x more in the
# centred cosine than in phase 6's encoder. Over 8 weight and 5 document
# seeds (tools/bert_bf16_agreement.py) the readings were raw >= 0.9999992,
# centred 0.9997840-0.9998357 and max |diff| 0.002897-0.003774, the key-mask
# fault centred <= 0.103 and max |diff| >= 0.815: the bf16 limits keep
# phase 6's raw floor and max |diff| and leave 2.3x on 1 - centred.
BERT_BF16_POOLED_LIMITS = (0.99999, 0.9995, 5e-3)
# phase 25: checkpointed resume at the masked-LM cell, 3 steps, save, 3 more
RESUME_STEPS = 3
RESUME_RTOL = 1e-6            # if the resumed run is not bit-equal
# phases 26-27: ContinuousGenerator and speculation over phase 10's LM
CG_SLOTS, CG_MAX_LEN = 16, 2 * GEN_T
SPEC_K = 4
DRAFT_DEPTH = 2
TG_NEW = 32                   # TextGenerator's maxNewTokens
TG_BPE_VOCAB = 4096
SPEC_SINGLE = 2               # phase 27's self-draft prompts one row at a time
TG_DRAFT_PROMPTS = 4          # phase 27's prompt strings through the draft


def bert_state_dict(torch, seed: int = 0) -> dict:
    """A BERT-base state dict in the HuggingFace layout (``bert.`` prefix,
    the ``position_ids`` buffer, a pretraining head under ``cls.`` that the
    converter drops) with BERT's initialiser: normal(0, 0.02) embeddings
    and dense weights, zero biases, LayerNorm 1/0, from torch.Generator."""
    gen = torch.Generator().manual_seed(seed)
    W, M = BERT_BASE["width"], BERT_BASE["mlp_dim"]

    def normal(*shape):
        return torch.randn(*shape, generator=gen) * 0.02

    sd = {"embeddings.word_embeddings.weight": normal(BERT_BASE["vocab"], W),
          "embeddings.position_embeddings.weight":
              normal(BERT_BASE["max_len"], W),
          "embeddings.token_type_embeddings.weight":
              normal(BERT_BASE["type_vocab"], W),
          "embeddings.position_ids":
              torch.arange(BERT_BASE["max_len"])[None]}
    dense = {"attention.self.query": (W, W), "attention.self.key": (W, W),
             "attention.self.value": (W, W),
             "attention.output.dense": (W, W),
             "intermediate.dense": (M, W), "output.dense": (W, M)}
    norms = ["embeddings.LayerNorm"]
    for i in range(BERT_BASE["depth"]):
        for name, shape in dense.items():
            sd[f"encoder.layer.{i}.{name}.weight"] = normal(*shape)
            sd[f"encoder.layer.{i}.{name}.bias"] = torch.zeros(shape[0])
        norms += [f"encoder.layer.{i}.attention.output.LayerNorm",
                  f"encoder.layer.{i}.output.LayerNorm"]
    for name in norms:
        sd[f"{name}.weight"] = torch.ones(W)
        sd[f"{name}.bias"] = torch.zeros(W)
    sd["pooler.dense.weight"] = normal(W, W)
    sd["pooler.dense.bias"] = torch.zeros(W)
    sd = {f"bert.{k}": v for k, v in sd.items()}
    sd["cls.predictions.bias"] = torch.zeros(BERT_BASE["vocab"])
    return sd


def wordpiece_vocab(texts) -> list:
    """A 30,522-entry vocabulary built in-process: the specials, single
    letters and their ``##`` continuations, then 19 of every 20 distinct
    document words (the rest split into letter pieces), filled with
    ``[unused*]`` entries."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + list(letters)
             + [f"##{c}" for c in letters])
    words = sorted({w for t in texts for w in t.split()} - set(letters))
    vocab += [w for i, w in enumerate(words) if i % 20]
    return vocab + [f"[unused{i}]"
                    for i in range(BERT_BASE["vocab"] - len(vocab))]


def k2a_at_bert_shape(torch, k2, dev, bw, flush, rows, phase, seed) -> dict:
    """K2a against its plain version at BERT-base's attention shape (the
    key mask of the padded token rows ``rows`` with the last row fully
    masked, bf16 and f32), then its bf16 time beside the plain version's,
    ``scaled_dot_product_attention``'s and the bound. Returns those numbers
    under the kernels line's keys."""
    import torch.nn.functional as F
    B, T = rows.shape
    H = BERT_BASE["heads"]
    D = BERT_BASE["width"] // H
    mask = torch.from_numpy(rows != 0).to(dev)
    mask_e = mask.clone()
    mask_e[-1] = False                            # one fully masked row
    gen = torch.Generator(device=dev).manual_seed(seed)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(B, T, H, D, generator=gen, device=dev,
                               dtype=dtype).transpose(1, 2)
                   for _ in range(3))
        bf16 = dtype == torch.bfloat16
        errs[dtype] = check_flash(
            torch, k2, f"{str(dtype)[6:]} B={B} H={H} T={T} D={D} (BERT-base)",
            q, k, v, mask_e, FLASH_BF16_RTOL if bf16 else 0.0,
            FLASH_BF16_ATOL if bf16 else FLASH_F32_ATOL)
        if bf16:
            ms = time_ms(lambda: k2.flash_cuda(q, k, v, mask), torch,
                         flush=flush)
            plain_ms = time_ms(lambda: k2.flash_torch(q, k, v, mask), torch,
                               runs=10, flush=flush)
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask[:, None, None, :]), torch,
                flush=flush)
            valid = int(mask.sum())
            bound_ms, bound_by = bound(
                4 * H * D * T * valid,
                2 * (2 * B * H * T * D + 2 * H * D * valid) + B * T, bw)
    print(f"{phase}: K2a {ms:.4f} ms; plain {plain_ms:.4f} ms; "
          f"scaled_dot_product_attention {library_ms:.4f} ms; bound "
          f"{bound_ms:.4f} ms by {bound_by} ({valid} valid keys); bf16, "
          f"median of CUDA-event runs, L2 flushed")
    return {"max_abs_err": max(errs.values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def bert_phase(torch, k1, k2, dev, bw, flush, texts, lengths):
    """Phase 24: BERT-base through ``TextEncoderFeaturizer`` and K2a.
    Returns K2a's record at this path's shape for the kernels line."""
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.dl import TextEncoderFeaturizer
    from mmlspark_torch.featurize import WordPieceTokenizerModel
    from mmlspark_torch.models import (LoadedModel, bert_encoder_from_torch,
                                       register_bert_encoder)
    B, T = len(texts), BERT_BASE["max_len"]
    H, W = BERT_BASE["heads"], BERT_BASE["width"]

    # the documents' first fifth, so rows spread under the 512 positions
    docs = np.asarray([" ".join(t.split()[:n // 5])
                       for t, n in zip(texts, lengths)], object)
    tok = WordPieceTokenizerModel.from_vocab(wordpiece_vocab(texts),
                                             maxLength=T, inputCol="text")
    t0 = time.perf_counter()
    ids = tok.transform(DataFrame({"text": docs}))
    tokenize_s = time.perf_counter() - t0
    rows = np.asarray(ids["tokens"], np.int32)
    n_tok = (rows != 0).sum(1)
    print(f"phase 24: WordPiece over a {BERT_BASE['vocab']:,}-entry vocab: "
          f"{B} documents in {tokenize_s:.3f} s, {int(n_tok.sum()):,} "
          f"tokens, {int(n_tok.min())}-{int(n_tok.max())} a row of {T}")

    k2a = k2a_at_bert_shape(torch, k2, dev, bw, flush, rows, "phase 24", 24)

    # the converter on the HF layout, then the featurizer: bf16 (timed),
    # then f32 (held with phase 6's limits)
    t0 = time.perf_counter()
    sd = bert_state_dict(torch)
    init_s = time.perf_counter() - t0
    schema = register_bert_encoder("BertBase", seq_len=T, **BERT_BASE)
    depth = BERT_BASE["depth"]
    for dtype, limits in ((torch.bfloat16, BERT_BF16_POOLED_LIMITS),
                          (torch.float32, POOLED_LIMITS)):
        name = str(dtype)[6:]
        t0 = time.perf_counter()
        module = bert_encoder_from_torch(
            sd, config={"num_attention_heads": H}, dtype=dtype)
        convert_s = time.perf_counter() - t0
        kw = dict(model=LoadedModel(schema, module), inputCol="tokens",
                  seqChunk=128)
        stage = TextEncoderFeaturizer(attentionImpl="pallas", **kw)
        stage.transform(ids)                      # warm-up
        torch.cuda.synchronize()
        times, launches = [], []
        for _ in range(BERT_RUNS):
            k1.hist_cuda.launches = k2.flash_cuda.launches = 0
            t0 = time.perf_counter()
            out = stage.transform(ids)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launches.append((k2.flash_cuda.launches, k1.hist_cuda.launches))
        if any(c != (depth, 0) for c in launches):
            fail(f"phase 24: {name}: (K2a, K1) launches per transform "
                 f"{launches}: expected ({depth}, 0), one K2a launch per "
                 "block")
        pooled = out["features"]
        if pooled.shape != (B, W) or not np.isfinite(pooled).all():
            fail(f"phase 24: {name}: pooled embeddings {pooled.shape}, "
                 f"{(~np.isfinite(pooled)).sum()} non-finite")
        transform_s = float(np.median(times))
        print(f"phase 24: BERT-base ({BERT_BASE}, {name}; seeded HF state "
              f"dict {init_s:.2f} s, converted in {convert_s:.2f} s) through "
              f"TextEncoderFeaturizer(pallas): warm transform "
              f"{transform_s:.4f} s, median of {BERT_RUNS} "
              f"({', '.join(f'{t:.4f}' for t in times)} s): "
              f"{B / transform_s:.2f} seqs/s, "
              f"{int(n_tok.sum()) / transform_s:,.0f} non-pad tokens/s; K2a "
              f"launches per transform {launches[-1][0]}")
        if dtype == torch.bfloat16:
            k2a_launches = launches[-1][0]
        k2.flash_cuda.launches = 0
        dense = TextEncoderFeaturizer(attentionImpl="dense", **kw) \
            .transform(ids)["features"]
        if k2.flash_cuda.launches != 0:
            fail("phase 24: the dense transform launched K2a")
        hold_pooled(torch, k2, dev, f"phase 24 ({name})", module, rows,
                    pooled, dense, limits)
        del module, stage, kw
        torch.cuda.empty_cache()
    del sd
    return {"name": "flash_bert", "route": "cuda",
            "source": "mmlspark_torch/dl/csrc/flash_attn.cu",
            "replaces": "mmlspark_tpu/dl/pallas_attention.py:77",
            "launches": k2a_launches, **k2a}


def resume_phase(torch, k2, dev, texts, args) -> int:
    """Phase 25: masked-LM training at phase 8's cell, checkpointed after 3
    steps and resumed in a fresh model and optimizer; the resumed steps
    must equal the uninterrupted ones. Returns K2b's launches a step."""
    import tempfile

    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.dl import (MaskedLMModel, TextEncoder, TrainState,
                                   make_attention_fn, make_train_step,
                                   mask_batch, masked_xent)
    from mmlspark_torch.dl.checkpoint import CheckpointManager
    from mmlspark_torch.dl.pretrain import default_optimizer
    from mmlspark_torch.featurize import TokenIdEncoder
    B, vocab, depth = args.batch, TEXT_SHAPE["vocab"], TEXT_SHAPE["depth"]
    ids = np.asarray(TokenIdEncoder(maxLength=TEXT_T, vocabSize=vocab - 1)
                     .transform(DataFrame({"text": texts}))["tokens"])
    rng = np.random.default_rng(25)
    batches = []
    for _ in range(2 * RESUME_STEPS):
        rows = ids[rng.integers(0, len(ids), size=B)]
        batches.append(tuple(torch.from_numpy(a).to(dev) for a in
                             mask_batch(rows, rng, mask_id=vocab - 1)))

    def new_state(seed):
        gen = torch.Generator().manual_seed(seed)
        model = MaskedLMModel(TextEncoder(
            **TEXT_SHAPE, attention_fn=make_attention_fn("pallas"),
            generator=gen), gen).to(dev)
        opt = default_optimizer(1e-3)(list(model.parameters()))
        return TrainState(model, opt), make_train_step(
            model, opt, loss_fn=masked_xent, fetch="logits")

    counters = {"K2b": k2.flash_lse_cuda, "K2d": k2.flash_dq_cuda,
                "K2e": k2.flash_dkv_cuda, "K2a": k2.flash_cuda,
                "K2c": k2.flash_causal_cuda}
    state, step = new_state(0)
    losses, per_step = [], []
    with tempfile.TemporaryDirectory() as root:
        mgr = CheckpointManager(root, max_to_keep=1)
        for i, (x, y) in enumerate(batches):
            reset(counters)
            state, loss = step(state, x, y)
            torch.cuda.synchronize()
            per_step.append(counts(counters))
            losses.append(loss)
            if i + 1 == RESUME_STEPS:
                t0 = time.perf_counter()
                path = mgr.save(state)
                save_s = time.perf_counter() - t0
                nbytes = sum(os.path.getsize(os.path.join(path, f))
                             for f in os.listdir(path))
        fresh, fresh_step = new_state(1)          # other initial weights
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = mgr.restore(target=fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    if restored.step != RESUME_STEPS:
        fail(f"phase 25: restored step {restored.step}, saved "
             f"{RESUME_STEPS}")
    resumed = []
    for x, y in batches[RESUME_STEPS:]:
        reset(counters)
        restored, loss = fresh_step(restored, x, y)
        torch.cuda.synchronize()
        per_step.append(counts(counters))
        resumed.append(loss)
    want = {"K2b": depth, "K2d": depth, "K2e": depth, "K2a": 0, "K2c": 0}
    if any(c != want for c in per_step):
        fail(f"phase 25: launches per step {per_step}: expected {want}")
    launches = per_step[-1]["K2b"]              # a resumed step's, measured
    a = torch.stack(losses[RESUME_STEPS:]).float()
    b = torch.stack(resumed).float()
    loss_rel = float(((a - b).abs() / a.abs()).max())
    same_bits = bool(torch.equal(a, b))
    worst, worst_name = 0.0, ""
    for (name, p), (_, r) in zip(state.model.state_dict().items(),
                                 restored.model.state_dict().items()):
        same_bits &= bool(torch.equal(p, r))
        rel = float((p.float() - r.float()).abs().max()
                    / p.float().abs().max().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, name
    print(f"phase 25: masked LM {TEXT_SHAPE}, batch {B} x T={TEXT_T}, "
          f"AdamW: steps 4-6 after a restore of step {RESUME_STEPS} into a "
          f"fresh model and optimizer against the uninterrupted run: "
          f"{'bit-equal' if same_bits else 'NOT bit-equal'} (losses "
          f"{', '.join(f'{float(v):.6f}' for v in a)}; largest relative "
          f"|diff| loss {loss_rel:.3g}, parameter {worst:.3g} "
          f"{worst_name}); save {save_s:.3f} s, restore {restore_s:.3f} s, "
          f"{nbytes / 1e6:,.1f} MB ({nbytes:,} B: weights, AdamW moments, "
          f"step); K2b, K2d, K2e {launches} launches a step, K2a 0")
    if not same_bits and (loss_rel > RESUME_RTOL or worst > RESUME_RTOL):
        fail(f"phase 25: the resumed run departs from the uninterrupted one "
             f"beyond {RESUME_RTOL} relative")
    del state, restored, fresh
    torch.cuda.empty_cache()
    return launches


def continuous_phase(torch, k2, k3, dev, model, dense, prompts, args) -> int:
    """Phase 26: ``ContinuousGenerator`` over phase 10's LM, 32 prompts
    through 16 slots. Returns K2c's launches a step."""
    from mmlspark_torch.dl import ContinuousGenerator
    from mmlspark_torch.obs import MetricsRegistry
    depth, new = TEXT_SHAPE["depth"], args.new_tokens
    fns = {"K2c": k2.flash_causal_cuda, "K2a": k2.flash_cuda,
           "K3 window": k3.paged_cuda, "K3 decode": k3.paged_decode_cuda}

    def run(n_prompts, n_new, slots, fault=False):
        """Submit (the causality probe runs on the first prompt), then
        drain; with ``fault`` the drain runs K2c one tile late."""
        gen = ContinuousGenerator(model, slots=slots, max_len=CG_MAX_LEN,
                                  registry=MetricsRegistry(), device=dev)
        for i, p in enumerate(prompts[:n_prompts]):
            gen.submit(i, p, n_new)
        reset(fns)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = with_k2c_one_tile_late(k2, gen.run_until_drained) if fault \
            else gen.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        seqs = np.stack([out[i][:GEN_T + n_new] for i in range(n_prompts)])
        return gen, seqs, wall

    gen, seqs, wall = run(len(prompts), new, CG_SLOTS)
    got = counts(fns)
    want = {"K2c": depth * gen.steps, "K2a": 0, "K3 window": 0,
            "K3 decode": 0}
    if got != want:
        fail(f"phase 26: launches {got} over {gen.steps} steps: expected "
             f"{want}, one K2c launch per block per step")
    launches = got["K2c"] // gen.steps             # measured, a step
    print(f"phase 26: ContinuousGenerator, {CG_SLOTS} slots, max_len "
          f"{CG_MAX_LEN}, {len(prompts)} prompts of {GEN_T} tokens, {new} "
          f"new each: {wall:.3f} s, {gen.steps} steps "
          f"({wall / gen.steps * 1e3:.3f} ms a step), "
          f"{len(prompts) * new / wall:,.0f} tokens/s; K2c {launches} "
          f"launches a step, K2a and K3 0")
    hold_rescore(torch, "phase 26: ContinuousGenerator", dense, seqs, GEN_T,
                 dev)
    _, faulty, _ = run(8, 16, 8, fault=True)
    hold_rescore(torch, "phase 26: planted fault (K2c bound one tile late)",
                 dense, faulty, GEN_T, dev, fault=True)
    return launches


def rescore_rows(torch, dense, rows, starts, n_new, dev):
    """Re-score generated rows whose continuations start at their own
    prompt lengths ``starts``: one ``rescore`` per distinct start. Returns
    (share of dense argmaxes, largest gap) over all rows."""
    hits, total, worst = 0.0, 0, 0.0
    for s in np.unique(starts):
        sel = rows[starts == s, :s + n_new]
        share, gap = rescore(torch, dense, sel, int(s), dev)
        hits += share * sel.shape[0] * n_new
        total += sel.shape[0] * n_new
        worst = max(worst, gap)
    return hits / total, worst


def speculative_phase(torch, k2, k3, dev, model, dense, prompts, args,
                      texts) -> None:
    """Phase 27: ``generate_speculative`` (a self-draft and a seeded depth-2
    draft) and ``TextGenerator`` with and without ``draftLm`` over phase
    10's LM."""
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.dl import (MaskedLMModel, TextEncoder, TextGenerator,
                                   generate, generate_speculative,
                                   make_attention_fn)
    from mmlspark_torch.featurize import BpeTokenizer
    depth, new, k = TEXT_SHAPE["depth"], args.new_tokens, SPEC_K
    fns = {"K2c": k2.flash_causal_cuda, "K2a": k2.flash_cuda,
           "K3 window": k3.paged_cuda, "K3 decode": k3.paged_decode_cuda}
    gen = torch.Generator().manual_seed(1)
    draft = MaskedLMModel(TextEncoder(
        **dict(TEXT_SHAPE, depth=DRAFT_DEPTH),
        attention_fn=make_attention_fn("pallas", causal=True),
        generator=gen), gen).to(dev).eval()

    def spec(drafter, p, label, d_depth):
        generate_speculative(model, drafter, p, max_new_tokens=new, k=k,
                             device=dev)     # probes, then warm
        reset(fns)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, rate = generate_speculative(model, drafter, p,
                                         max_new_tokens=new, k=k, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts(fns)
        want = {"K2c": depth + d_depth, "K2a": 0, "K3 window": 0,
                "K3 decode": 0}
        if got != want:
            fail(f"phase 27: {label}: launches {got}, expected {want} (the "
                 "target's and the draft's prefill, one K2c launch a block)")
        share, gap = rescore(torch, dense, out, GEN_T, dev)
        print(f"phase 27: {label}, k={k}, {p.shape[0]} x {GEN_T} prompt "
              f"tokens, {new} new: {wall:.3f} s, "
              f"{p.shape[0] * new / wall:,.0f} tokens/s, tokens per pass "
              f"{rate:.4f}; K2c {got['K2c']} (the prefills); re-scored: "
              f"{share:.4f} dense argmax, largest gap {gap:.4f} (limit "
              f"{RESCORE_DELTA})")
        if gap > RESCORE_DELTA:
            fail(f"phase 27: {label}: generated tokens fail the re-score "
                 "limit")
        return rate

    single = [spec(model, prompts[i:i + 1], f"self-draft, prompt {i}", depth)
              for i in range(SPEC_SINGLE)]
    rate = float(np.mean(single))
    print(f"phase 27: self-draft tokens per pass, one row at a time: "
          f"{', '.join(f'{r:.4f}' for r in single)}; mean {rate:.4f} (floor "
          f"{0.9 * (k + 1):.1f})")
    if rate < 0.9 * (k + 1):
        fail(f"phase 27: self-draft tokens per pass {rate:.4f} below "
             f"0.9 x (k + 1)")
    batched = spec(model, prompts, "self-draft, 32 rows synced on the "
                   "minimum acceptance", depth)
    spec(draft, prompts, f"seeded depth-{DRAFT_DEPTH} draft, 32 rows",
         DRAFT_DEPTH)
    if batched < 1.0:
        fail(f"phase 27: batched self-draft tokens per pass {batched}")

    # TextGenerator over prompt strings through a fitted BpeTokenizer
    t0 = time.perf_counter()
    tok = BpeTokenizer(vocabSize=TG_BPE_VOCAB, maxLength=GEN_T,
                       inputCol="text", outputCol="tokens").fit(
        DataFrame({"text": texts}))
    fit_s = time.perf_counter() - t0
    # ragged prompts (the draft path runs one call per distinct length);
    # the blank prompt's UNK row is held on the CPU: here every row has a
    # prefix to prefill through K2c
    df = DataFrame({"text": np.asarray([" ".join(t.split()[:8 + 2 * i])
                                        for i, t in enumerate(texts)],
                                       object)})
    starts = np.maximum((np.asarray(tok.transform(df)["tokens"]) != 0)
                        .sum(1), 1)
    gen_mod = sys.modules["mmlspark_torch.dl.generate"]
    spec_mod = sys.modules["mmlspark_torch.dl.speculative"]
    # the draft path runs one decode call per distinct prompt length: it
    # takes the first TG_DRAFT_PROMPTS strings
    for label, drafter, n_df in (
            ("plain", None, len(df)),
            (f"depth-{DRAFT_DEPTH} draft", draft, TG_DRAFT_PROMPTS)):
        frame = df.take(list(range(n_df)))
        st = starts[:n_df]
        stage = TextGenerator(tokenizer=tok, lm=model, draftLm=drafter,
                              maxNewTokens=TG_NEW, speculativeK=k)
        stage.transform(frame)                     # warm
        calls = []

        def spy(real):
            def run(*a, **kw):
                out = real(*a, **kw)
                calls.append(out[0] if isinstance(out, tuple) else out)
                return out
            return run

        reals = gen_mod.generate, spec_mod.generate_speculative
        gen_mod.generate = spy(reals[0])
        spec_mod.generate_speculative = spy(reals[1])
        reset(fns)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = stage.transform(frame)["generated"]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            gen_mod.generate, spec_mod.generate_speculative = reals
        launched = counts(fns)
        groups = len(calls)
        want_k2c = depth if drafter is None else groups * (depth
                                                           + DRAFT_DEPTH)
        if launched != {"K2c": want_k2c, "K2a": 0, "K3 window": 0,
                        "K3 decode": 0}:
            fail(f"phase 27: TextGenerator ({label}): launches {launched}, "
                 f"expected K2c {want_k2c} over {groups} call(s)")
        if drafter is None:
            rows = calls[0]
        else:                  # the stage's calls, one per prompt length
            rows = np.zeros((len(st), GEN_T + TG_NEW), np.int32)
            for out, plen in zip(calls, np.unique(st)):
                rows[np.flatnonzero(st == plen), :plen + TG_NEW] = out
        texts_back = [tok.decode(r[s:s + TG_NEW])
                      for r, s in zip(rows, st)]
        if list(got) != texts_back:
            fail(f"phase 27: TextGenerator ({label}) text differs from its "
                 "decoded tokens")
        share, gap = rescore_rows(torch, dense, rows, st, TG_NEW, dev)
        print(f"phase 27: TextGenerator ({label}), {n_df} prompt strings "
              f"({int(st.min())}-{int(st.max())} BPE tokens, "
              f"{TG_BPE_VOCAB:,}-entry BpeTokenizer fitted on the documents "
              f"in {fit_s:.2f} s), {TG_NEW} new: {wall:.3f} s, "
              f"{n_df * TG_NEW / wall:,.0f} tokens/s; {groups} decode "
              f"call(s), K2c {launched['K2c']}; re-scored: {share:.4f} dense "
              f"argmax, largest gap {gap:.4f} (limit {RESCORE_DELTA})")
        if gap > RESCORE_DELTA:
            fail(f"phase 27: TextGenerator ({label}): generated tokens fail "
                 "the re-score limit")
    del draft


def dense_engine_phase(torch, k2, k3, dev, model, dense, prompts,
                       args) -> None:
    """Phase 28: ``LLMEngine`` under ``MMLSPARK_TPU_PAGED_ATTN=0`` on phase
    11's round 3, beside the paged mode in the same process."""
    import mmlspark_torch.serving.llm as llm
    from mmlspark_torch.obs import MetricsRegistry
    from mmlspark_torch.serving import LLMEngine
    new, svc = args.new_tokens, "llm"
    fns = {"K2c": k2.flash_causal_cuda, "K2a": k2.flash_cuda,
           "K3 window": k3.paged_cuda, "K3 decode": k3.paged_decode_cuda}
    max_seq, slots, batch = 18 * 16, 16, 4

    def round3(mode):
        reg = MetricsRegistry()
        eng = LLMEngine(model, slots=slots, block_len=16,
                        max_seq_len=max_seq, num_blocks=1 + 2 * 16 * 18,
                        prefill_batch=batch, registry=reg, device=dev)
        eng.warm(prefill_windows=(llm._bucket_window(GEN_T), 1))
        gathers.clear()
        if eng.decoder.paged != (mode == "paged") \
                or eng.prefiller.paged != (mode == "paged"):
            fail(f"phase 28: the engine did not build the {mode} mode")
        reset(fns)
        k3.paged_decode_cuda.combine_launches = 0
        k3.paged_cuda.combine_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, p in enumerate(prompts):
            eng.submit(i, p, new)
        out = eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        seqs = np.stack([out[i] for i in range(len(prompts))])
        return eng, reg, seqs, wall, counts(fns)

    # what each gather_dense call materialized, read off the tensors it
    # returned: (chains gathered, bytes)
    gathers, gather_dense = [], llm.gather_dense

    def measured_gather(pools, rows, head_dim):
        out = gather_dense(pools, rows, head_dim)
        gathers.append((rows.shape[0], sum(t.numel() * t.element_size()
                                           for kv in out for t in kv)))
        return out

    old = os.environ.get("MMLSPARK_TPU_PAGED_ATTN")
    os.environ["MMLSPARK_TPU_PAGED_ATTN"] = "0"
    llm.gather_dense = measured_gather
    try:
        eng, reg, seqs, wall, got = round3("dense")
    finally:
        llm.gather_dense = gather_dense
        if old is None:
            del os.environ["MMLSPARK_TPU_PAGED_ATTN"]
        else:
            os.environ["MMLSPARK_TPU_PAGED_ATTN"] = old
    combines = (k3.paged_decode_cuda.combine_launches,
                k3.paged_cuda.combine_launches)
    if got != {"K2c": 0, "K2a": 0, "K3 window": 0, "K3 decode": 0} \
            or combines != (0, 0):
        fail(f"phase 28: dense mode launched {got}, combines {combines}: "
             "expected no K3 (and no combine), no K2a or K2c")
    h = reg.metrics("gen_decode_attn_seconds")[0]
    c = reg.metrics("kv_dense_gather_bytes_total")[0]
    steps = {ph: h.count(service=svc, phase=ph)
             for ph in ("prefill", "decode")}
    gathered = {ph: c.value(service=svc, phase=ph) for ph in steps}
    rows = {"prefill": batch, "decode": slots}
    calls = {ph: sum(n == rows[ph] for n, _ in gathers) for ph in rows}
    want = {ph: float(sum(b for n, b in gathers if n == rows[ph]))
            for ph in rows}
    if calls != steps or len(gathers) != sum(steps.values()) \
            or gathered != want or min(gathered.values()) <= 0:
        fail(f"phase 28: kv_dense_gather_bytes_total {gathered} over "
             f"{steps} prefill batches and decode steps; the gathers "
             f"returned {want} B in {calls} calls (expected one gather per "
             "prefill batch and per decode step, every byte counted)")
    del eng
    _, _, paged_seqs, paged_wall, paged_got = round3("paged")
    same = int(sum(np.array_equal(a, b) for a, b in zip(seqs, paged_seqs)))
    n_tok = len(prompts) * new
    print(f"phase 28: LLMEngine round 3 (phase 11's: {len(prompts)} prompts "
          f"of {GEN_T}, {new} new, {slots} slots) under "
          f"MMLSPARK_TPU_PAGED_ATTN=0: {wall:.3f} s, {n_tok / wall:,.0f} "
          f"tokens/s; paged mode in this process {paged_wall:.3f} s, "
          f"{n_tok / paged_wall:,.0f} tokens/s; {steps['prefill']} prefill "
          f"batches, {steps['decode']} decode steps; "
          f"kv_dense_gather_bytes_total prefill {gathered['prefill']:,.0f} "
          f"B, decode {gathered['decode']:,.0f} B; K3 (and its combines) 0 "
          f"launches (paged mode: window {paged_got['K3 window']}, decode "
          f"{paged_got['K3 decode']}); {same} of {len(prompts)} sequences "
          f"identical to the paged mode's")
    hold_rescore(torch, "phase 28: dense re-gather mode", dense, seqs, GEN_T,
                 dev)


def textgen_phases(torch, k1, k2, k3, dev, bw, flush, texts, lengths,
                   args) -> dict:
    """Phases 24-28. Returns K2a's record at the BERT-base shape and the
    launch counts the other kernels' records take."""
    import copy

    from mmlspark_torch.dl import make_attention_fn
    with Phase("phase 24"):
        record = bert_phase(torch, k1, k2, dev, bw, flush, texts, lengths)
    with Phase("phase 25"):
        resume = resume_phase(torch, k2, dev, texts, args)
    model = lm_model(torch, "pallas").to(dev).eval()
    dense = copy.deepcopy(model)
    dense.encoder = dense.encoder.with_attention(
        make_attention_fn("dense", causal=True))
    prompts = np.random.default_rng(11).integers(
        2, TEXT_SHAPE["vocab"], size=(GEN_BATCH, GEN_T)).astype(np.int32)
    with Phase("phase 26"):
        continuous = continuous_phase(torch, k2, k3, dev, model, dense,
                                      prompts, args)
    with Phase("phase 27"):
        speculative_phase(torch, k2, k3, dev, model, dense, prompts, args,
                          texts)
    with Phase("phase 28"):
        dense_engine_phase(torch, k2, k3, dev, model, dense, prompts, args)
    return {"record": record, "resume_launches_per_step": resume,
            "continuous_launches_per_step": continuous}


# ----------------------------------------------------------------- vision

# phases 29-32: the DL inference slice at full width. 1,024 seeded uint8 BGR
# images of 256 x 256, resized to the zoo's 224 by ImageFeaturizer's
# autoResize, minibatches of 64; seeded torchvision-layout ResNet-50 and
# ViT-B/16 state dicts through the port's converters
VISION_IMAGES, VISION_SRC, VISION_BATCH = 1024, 256, 64
VISION_RUNS = 3               # warm transforms timed (median)
VISION_CPU_ROWS = 8           # rows held against the port on the CPU
VISION_F32_RTOL = 1e-4        # card f32 against the CPU, of the largest value
RESIZE_ATOL = 5e-3            # the card's resize against the numpy formula
CUT_RTOL = 1e-6               # a cut layer against the model's own endpoint
QUANT_COS_MIN = 0.99          # tests/test_quantize.py:45, the JAX bound
CHAIN_RTOL = 1e-5             # ImageTransformer/UnrollImage, card vs CPU
# bf16 against f32 on the card: the smallest per-row cosine and max |diff|
# over the largest f32 value. Over 4 weight and 2 image seeds
# (tools/vision_bf16_agreement.py, PERF.md §6; NVIDIA H100 80GB HBM3,
# 700.00 W) ResNet-50 read 0.9999906-0.9999925 and 4.373e-3-5.330e-3,
# ViT-B/16 0.9999384-0.9999456 and 1.555e-2-2.047e-2: the limits leave
# 2.5x on 1 - cosine and ~2x on max |diff|
VISION_BF16_LIMITS = {"ResNet50": (0.99997, 0.012),
                      "ViT_B_16": (0.99985, 0.045)}


def vision_images(n: int = VISION_IMAGES, seed: int = 29) -> np.ndarray:
    """``n`` seeded uint8 BGR images of ``VISION_SRC`` squared: smooth
    gradients (a random affine ramp per channel) plus uniform noise of
    +-48, clipped to 0-255, so resizing has both low and high frequencies
    to keep or alias."""
    rng = np.random.default_rng(seed)
    ax = np.linspace(0.0, 1.0, VISION_SRC, dtype=np.float32)
    out = np.empty((n, VISION_SRC, VISION_SRC, 3), np.uint8)
    for i in range(n):
        a = rng.uniform(-128, 128, (2, 3)).astype(np.float32)
        base = rng.uniform(64, 192, 3).astype(np.float32)
        img = base + ax[:, None, None] * a[0] + ax[None, :, None] * a[1]
        img += rng.uniform(-48, 48, img.shape).astype(np.float32)
        out[i] = np.clip(img, 0, 255).astype(np.uint8)
    return out


def resnet50_state_dict(torch, seed: int = 0) -> dict:
    """A torchvision ResNet-50 state dict (``conv1``, ``bn1``,
    ``layer<L>.<B>.conv<k>``/``bn<k>``/``downsample``, ``fc``, the
    ``num_batches_tracked`` buffers the converter drops) with He-normal
    convs (the stem's scaled by 1/128 for 0-255 pixels), every BatchNorm
    scale non-zero (each block's last in [0.1, 0.3], the others in
    [0.5, 1.0]), non-zero running statistics and biases."""
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape, std):
        return torch.randn(*shape, generator=gen) * std

    def uniform(n, lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen)

    sd = {}

    def conv(name, cout, cin, k, scale=1.0):
        sd[f"{name}.weight"] = normal(cout, cin, k, k, std=scale * (
            2.0 / (cin * k * k)) ** 0.5)

    def bn(name, c, last=False):
        sd[f"{name}.weight"] = uniform(c, 0.1, 0.3) if last \
            else uniform(c, 0.5, 1.0)
        sd[f"{name}.bias"] = normal(c, std=0.05)
        sd[f"{name}.running_mean"] = normal(c, std=0.1)
        sd[f"{name}.running_var"] = uniform(c, 0.5, 1.5)
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    conv("conv1", 64, 3, 7, scale=1 / 128)
    bn("bn1", 64)
    cin = 64
    for li, n in enumerate((3, 4, 6, 3)):
        f = 64 * 2 ** li
        for bj in range(n):
            t = f"layer{li + 1}.{bj}"
            conv(f"{t}.conv1", f, cin, 1)
            bn(f"{t}.bn1", f)
            conv(f"{t}.conv2", f, f, 3)
            bn(f"{t}.bn2", f)
            conv(f"{t}.conv3", 4 * f, f, 1)
            bn(f"{t}.bn3", 4 * f, last=True)
            if bj == 0:
                conv(f"{t}.downsample.0", 4 * f, cin, 1)
                bn(f"{t}.downsample.1", 4 * f)
            cin = 4 * f
    sd["fc.weight"] = normal(1000, 2048, std=0.01)
    sd["fc.bias"] = normal(1000, std=0.01)
    return sd


def vit_b16_state_dict(torch, seed: int = 0) -> dict:
    """A torchvision ``vit_b_16`` state dict (``conv_proj``,
    ``class_token``, ``encoder.pos_embedding``, ``encoder.layers.
    encoder_layer_i`` with the fused ``in_proj_weight``, ``mlp.0``/``mlp.3``,
    ``encoder.ln``, ``heads.head``): patch embeddings of std ~0.03 on
    0-255 pixels, a non-zero class token and positions (std 0.02), q/k/v
    and ``mlp.0`` lecun-scaled, and the residual branches' output
    projections scaled so each block adds ~0.01 std, the residual stream's
    scale in pretrained ViTs' early layers; LayerNorms near 1/0."""
    gen = torch.Generator().manual_seed(seed)
    W, M, depth = 768, 3072, 12

    def normal(*shape, std):
        return torch.randn(*shape, generator=gen) * std

    sd = {"conv_proj.weight": normal(W, 3, 16, 16, std=7.4e-6),
          "conv_proj.bias": normal(W, std=0.01),
          "class_token": normal(1, 1, W, std=0.02),
          "encoder.pos_embedding": normal(1, 197, W, std=0.02)}

    def ln(name):
        sd[f"{name}.weight"] = 1.0 + normal(W, std=0.1)
        sd[f"{name}.bias"] = normal(W, std=0.02)

    for i in range(depth):
        t = f"encoder.layers.encoder_layer_{i}"
        ln(f"{t}.ln_1")
        sd[f"{t}.self_attention.in_proj_weight"] = normal(
            3 * W, W, std=W ** -0.5)
        sd[f"{t}.self_attention.in_proj_bias"] = normal(3 * W, std=0.02)
        sd[f"{t}.self_attention.out_proj.weight"] = normal(
            W, W, std=0.01 * W ** -0.5)
        sd[f"{t}.self_attention.out_proj.bias"] = normal(W, std=0.002)
        ln(f"{t}.ln_2")
        sd[f"{t}.mlp.0.weight"] = normal(M, W, std=W ** -0.5)
        sd[f"{t}.mlp.0.bias"] = normal(M, std=0.02)
        sd[f"{t}.mlp.3.weight"] = normal(W, M, std=0.02 * M ** -0.5)
        sd[f"{t}.mlp.3.bias"] = normal(W, std=0.002)
    ln("encoder.ln")
    sd["heads.head.weight"] = normal(1000, W, std=0.02)
    sd["heads.head.bias"] = normal(1000, std=0.01)
    return sd


def resize_reference(images: np.ndarray, size: int) -> np.ndarray:
    """``jax.image.resize(method="linear")`` in float64 numpy, written from
    its definition (a triangle kernel widened by the scale when
    downsampling, each output's weights normalised), independent of the
    port's ``image/ops.py``."""
    def weights(n_in, n_out):
        scale = n_out / n_in
        support = max(1.0 / scale, 1.0)
        centre = (np.arange(n_out) + 0.5) / scale - 0.5
        w = np.maximum(0.0, 1.0 - np.abs(
            centre[None, :] - np.arange(n_in)[:, None]) / support)
        return w / w.sum(0, keepdims=True)

    x = images.astype(np.float64)
    x = np.einsum("nhwc,ho->nowc", x, weights(x.shape[1], size))
    return np.einsum("nhwc,wp->nhpc", x, weights(x.shape[2], size))


# each record of the kernels line, and the wrapper counters its launches
# are read from
VISION_COUNTERS = {
    "hist": ("hist_cuda",),
    "flash": ("flash_cuda",), "flash_bert": ("flash_cuda",),
    "flash_control": ("flash_cuda",),
    "flash_causal": ("flash_causal_cuda",),
    "flash_lse": ("flash_lse_cuda",),
    "flash_lse_causal": ("flash_lse_cuda.causal",),
    "flash_bwd_dq": ("flash_dq_cuda",),
    "flash_bwd_dq_causal": ("flash_dq_cuda.causal",),
    "flash_bwd_dkv": ("flash_dkv_cuda",),
    "flash_bwd_dkv_causal": ("flash_dkv_cuda.causal",),
    "paged_attention": ("paged_decode_cuda",),
    "paged_attention_window": ("paged_cuda",),
    "paged_attention_combine": ("paged_cuda.combine",
                                "paged_decode_cuda.combine")}


class VisionGuard:
    """``with VisionGuard(k1, k2, k3, phase, totals):`` sets every kernel's
    launch counts to 0 and counts the plain versions' calls; on exit it
    fails if any kernel launched or any plain version ran (the vision path
    runs no Pallas kernel's counterpart). ``.counts`` keeps the launches
    read, one entry for each counter :data:`VISION_COUNTERS` names, and
    adds them into ``totals``."""

    def __init__(self, k1, k2, k3, phase: str, totals: dict):
        self.phase, self.totals = phase, totals
        self.wrappers = {"hist_cuda": k1.hist_cuda}
        self.wrappers.update({n: getattr(k2, n) for n in (
            "flash_cuda", "flash_causal_cuda", "flash_lse_cuda",
            "flash_dq_cuda", "flash_dkv_cuda")})
        self.wrappers.update({n: getattr(k3, n) for n in (
            "paged_cuda", "paged_decode_cuda")})
        self.plain = [(k1, "hist_torch")] + [(k2, n) for n in (
            "flash_torch", "flash_lse_torch", "flash_dq_torch",
            "flash_dkv_torch")] + [(k3, "paged_torch")]

    def __enter__(self):
        reset(self.wrappers)
        for fn in self.wrappers.values():
            if hasattr(fn, "causal_launches"):
                fn.causal_launches = 0
        self.calls, self.saved = [0], []
        for module, name in self.plain:
            original = getattr(module, name)

            def counted(*a, _f=original, **kw):
                self.calls[0] += 1
                return _f(*a, **kw)
            self.saved.append((module, name, original))
            setattr(module, name, counted)
        return self

    def __exit__(self, *exc):
        for module, name, original in self.saved:
            setattr(module, name, original)
        if exc[0] is not None:
            return False
        self.counts = {}
        for n, fn in self.wrappers.items():
            self.counts[n] = fn.launches
            for attr, suffix in (("combine_launches", ".combine"),
                                 ("causal_launches", ".causal")):
                if hasattr(fn, attr):
                    self.counts[n + suffix] = getattr(fn, attr)
        for n, c in self.counts.items():
            self.totals[n] = self.totals.get(n, 0) + c
        if any(self.counts.values()) or self.calls[0]:
            fail(f"{self.phase}: the vision path launched a kernel "
                 f"{ {n: c for n, c in self.counts.items() if c} } or "
                 f"called a plain version {self.calls[0]} times")
        print(f"{self.phase}: K1, K2a-K2e and K3 launches 0, plain-version "
              "calls 0")
        return False


def profile_transform(torch, fn, unprofiled_s: float, phase: str, k=8):
    """Device time, busy share (device time over the unprofiled call's
    wall seconds) and the top ``k`` device kernels and copies over one
    call of ``fn``, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.device_time)
    device_us = sum(sum(v) for v in by_name.values())
    print(f"{phase}: device time {device_us / 1e3:.3f} ms in "
          f"{sum(len(v) for v in by_name.values())} kernels and copies; "
          f"busy share {device_us / 1e6 / unprofiled_s:.3f} of the "
          f"unprofiled {unprofiled_s:.4f} s")
    for name, times in sorted(by_name.items(),
                              key=lambda kv: -sum(kv[1]))[:k]:
        print(f"  {sum(times) / 1e3:9.3f} ms  {len(times):5d} x  "
              f"{name[:90]}")
    return device_us / 1e3


def row_agreement(got: np.ndarray, want: np.ndarray) -> tuple:
    """(min per-row cosine, max |diff| over the largest |want|)."""
    g, w = got.astype(np.float64), want.astype(np.float64)
    cos = (g * w).sum(1) / np.maximum(
        np.linalg.norm(g, axis=1) * np.linalg.norm(w, axis=1), 1e-30)
    return float(cos.min()), float(np.abs(g - w).max() / np.abs(w).max())


def timed_transforms(torch, stage, df, phase: str, label: str):
    """A warm-up, then ``VISION_RUNS`` timed transforms (each returns host
    arrays, so it ends synchronized). Returns (features, median s)."""
    stage.transform(df)
    times = []
    for _ in range(VISION_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = stage.transform(df)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    s = float(np.median(times))
    feats = out[stage.getOutputCol()]
    if not np.isfinite(feats).all():
        fail(f"{phase}: {label}: {(~np.isfinite(feats)).sum()} non-finite "
             "features")
    print(f"{phase}: {label}: warm transform {s:.4f} s, median of "
          f"{VISION_RUNS} ({', '.join(f'{t:.4f}' for t in times)} s): "
          f"{len(df) / s:,.1f} images/s; last_transform_stats "
          f"{stage.last_transform_stats}")
    return feats, s


def hold_rows(phase: str, what: str, got, want, rtol: float,
              must_fail: bool = False) -> float:
    """max |got - want| within ``rtol`` of the largest |want|; with
    ``must_fail`` a planted fault that has to break that limit."""
    err = float(np.abs(got.astype(np.float64) - want).max()
                / np.abs(want).max())
    ok = err <= rtol
    print(f"{phase}: {what}: max |diff| {err:.3e} of the largest value "
          f"(limit {rtol:g}){' — planted fault' if must_fail else ''}")
    if ok == must_fail:
        fail(f"{phase}: {what}: {err:.3e} {'within' if ok else 'past'} "
             f"{rtol:g}")
    return err


def backbone_phase(torch, guard, dev, images, args, name: str,
                   phase: str) -> dict:
    """Phase 29 (``ResNet50``) or 30 (``ViT_B_16``): ``ImageFeaturizer``
    over the seeded weights, bf16 timed and profiled, then held against
    f32 on the card, the port on the CPU, a cut layer and planted faults.
    Returns the bf16 model, its schema, features and images/s."""
    import copy
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.image import ImageFeaturizer, ResizeImageTransformer
    from mmlspark_torch.models import LoadedModel, get_model, module_from_torch
    schema = get_model(name)
    t0 = time.perf_counter()
    sd = (resnet50_state_dict if name == "ResNet50"
          else vit_b16_state_dict)(torch, args.vision_seed)
    models = {dt: module_from_torch(sd, name, dtype=getattr(torch, dt))
              for dt in ("bfloat16", "float32")}
    print(f"{phase}: {name}, seeded torchvision state dict ({len(sd)} "
          f"entries, {sum(v.numel() for v in sd.values()):,} values) "
          f"converted in {time.perf_counter() - t0:.2f} s")
    df = DataFrame({"image": images})
    n = len(images)

    def featurizer(model, **kw):
        return ImageFeaturizer(model=LoadedModel(schema, model),
                               miniBatchSize=VISION_BATCH, **kw)

    with guard(phase):
        stage = featurizer(models["bfloat16"])
        bf16, bf16_s = timed_transforms(torch, stage, df, phase, "bf16")
        width = models["float32"].head.weight.shape[1]
        if bf16.shape != (n, width):
            fail(f"{phase}: pooled features {bf16.shape}, expected "
                 f"{(n, width)}")
        profile_transform(torch, lambda: stage.transform(df), bf16_s, phase)
        f32, f32_s = timed_transforms(
            torch, featurizer(models["float32"]), df, phase, "f32 (TF32 off)")
        cos, rel = row_agreement(bf16, f32)
        floor, ceiling = VISION_BF16_LIMITS[name]
        print(f"{phase}: bf16 against f32: min per-row cosine {cos:.7f} "
              f"(floor {floor}), max |diff| {rel:.3e} of the largest "
              f"(limit {ceiling})")
        if cos < floor or rel > ceiling:
            fail(f"{phase}: bf16 against f32 outside "
                 f"({floor}, {ceiling})")

        # the card's f32 against the port on the CPU
        rows = images[:VISION_CPU_ROWS]
        cpu_model = copy.deepcopy(models["float32"]).cpu()
        cpu = ImageFeaturizer(model=LoadedModel(schema, cpu_model),
                              miniBatchSize=VISION_CPU_ROWS, device="cpu") \
            .transform(DataFrame({"image": rows}))["features"]
        hold_rows(phase, f"card f32 against device='cpu' on "
                  f"{VISION_CPU_ROWS} rows", f32[:VISION_CPU_ROWS], cpu,
                  VISION_F32_RTOL)

        # the resize against its formula in numpy, and a bilinear resize
        # without antialiasing as a planted fault
        resized = ResizeImageTransformer(
            height=224, width=224).transform(
                DataFrame({"image": rows}))["image"]
        want = resize_reference(rows, 224)
        err = float(np.abs(resized - want).max())
        print(f"{phase}: resize 256 -> 224 against the numpy formula: max "
              f"|diff| {err:.2e} on 0-255 (limit {RESIZE_ATOL})")
        if err > RESIZE_ATOL:
            fail(f"{phase}: resize {err} past {RESIZE_ATOL}")
        plain = torch.nn.functional.interpolate(
            torch.from_numpy(rows).to(dev).float().permute(0, 3, 1, 2),
            size=(224, 224), mode="bilinear", align_corners=False,
            antialias=False).permute(0, 2, 3, 1).cpu().numpy()
        err = float(np.abs(plain - want).max())
        print(f"{phase}: a resize without antialiasing: max |diff| "
              f"{err:.2f} — planted fault")
        if err <= RESIZE_ATOL:
            fail(f"{phase}: the unantialiased resize passed the hold")

        # a cut layer: the featurizer's flattened endpoint against the
        # model's own on the same resized, bf16-narrowed minibatch
        endpoint = schema.layer_names[-3]
        batch = images[:VISION_BATCH]
        cut = featurizer(models["bfloat16"], cutOutputLayers=2).transform(
            DataFrame({"image": batch}))["features"]
        x = torch.from_numpy(ResizeImageTransformer(
            height=224, width=224).transform(DataFrame({"image": batch}))[
                "image"]).to(torch.bfloat16).to(dev)
        with torch.inference_mode():
            direct = models["bfloat16"].to(dev)(x)[endpoint].float() \
                .cpu().numpy()
        print(f"{phase}: cutOutputLayers=2 is {endpoint!r}, "
              f"{tuple(direct.shape[1:])} a row")
        hold_rows(phase, f"cutOutputLayers=2 against a numpy reshape of "
                  f"{endpoint}", cut, direct.reshape(len(batch), -1),
                  CUT_RTOL)
        fault = copy.deepcopy(models["bfloat16"])
        if name == "ResNet50":
            # stage endpoints handed out in NCHW order
            forward = fault.forward

            def nchw(x, train=False, _f=forward):
                out = _f(x, train)
                return {k: v.permute(0, 3, 1, 2) if k.startswith("stage")
                        else v for k, v in out.items()}
            fault.forward = nchw
            got = featurizer(fault, cutOutputLayers=2).transform(
                DataFrame({"image": batch}))["features"]
            hold_rows(phase, "stage4 endpoints in NCHW order", got,
                      direct.reshape(len(batch), -1), CUT_RTOL,
                      must_fail=True)
        else:
            # LayerNorm eps 1e-5 (torch's default) in place of flax's 1e-6
            fault = copy.deepcopy(models["float32"])
            for m in fault.modules():
                if isinstance(m, torch.nn.LayerNorm):
                    m.eps = 1e-5
            got = featurizer(fault).transform(
                DataFrame({"image": rows}))["features"]
            hold_rows(phase, "LayerNorm eps 1e-5, card f32 against the CPU",
                      got, cpu, VISION_F32_RTOL, must_fail=True)
        del fault
    torch.cuda.empty_cache()
    return {"schema": schema, "bf16": models["bfloat16"],
            "f32": models["float32"], "features": bf16,
            "f32_features": f32, "images_per_s": n / bf16_s}


def quantized_phase(torch, guard, dev, images, r29) -> None:
    """Phase 31: ``ImageFeaturizer(quantize=True)`` on phase 29's model:
    images/s beside bf16; the pooled cosine against f32; conv_init's int32
    product bit-equal on the card and the CPU from the same int8 inputs;
    a row's features the same with and without outlier neighbours."""
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.image import ImageFeaturizer, ResizeImageTransformer
    from mmlspark_torch.models import (LoadedModel, cosine_fidelity,
                                       quantize_resnet)
    from mmlspark_torch.models.quantize import (_im2col, _quantize_rows,
                                                int8_matmul)
    phase = "phase 31"
    df = DataFrame({"image": images})
    with guard(phase):
        stage = ImageFeaturizer(model=LoadedModel(r29["schema"], r29["bf16"]),
                                quantize=True, miniBatchSize=VISION_BATCH)
        q, q_s = timed_transforms(torch, stage, df, phase, "int8")
        print(f"{phase}: int8 {len(images) / q_s:,.1f} images/s against "
              f"bf16 {r29['images_per_s']:,.1f} "
              f"({len(images) / q_s / r29['images_per_s']:.3f}x)")
        profile_transform(torch, lambda: stage.transform(df), q_s, phase)
        mean_cos = cosine_fidelity(q, r29["f32_features"])
        min_cos, rel = row_agreement(q, r29["f32_features"])
        print(f"{phase}: int8 against f32: mean per-row cosine "
              f"{mean_cos:.6f} (floor {QUANT_COS_MIN}), min {min_cos:.6f}, "
              f"max |diff| {rel:.3e} of the largest")
        if mean_cos < QUANT_COS_MIN:
            fail(f"{phase}: int8 fidelity {mean_cos} below {QUANT_COS_MIN}")

        qf, qp = quantize_resnet(r29["bf16"].to(dev))
        rows = images[:VISION_CPU_ROWS]
        x = torch.from_numpy(ResizeImageTransformer(
            height=224, width=224).transform(DataFrame({"image": rows}))[
                "image"]).to(dev)
        xq, _ = _quantize_rows(x)
        patches, _ = _im2col(xq, 7, 7, 2, 3)
        wq = qp["conv_init"][0]
        w2 = wq.reshape(-1, wq.shape[-1])
        card = int8_matmul(patches, w2).cpu()
        host = int8_matmul(patches.cpu(), w2.cpu())
        exact = patches.cpu().long() @ w2.cpu().long()
        print(f"{phase}: conv_init int32 product {tuple(card.shape)}, "
              f"|sum| up to {int(exact.abs().max()):,}: card == CPU "
              f"{torch.equal(card, host)}, == int64 "
              f"{torch.equal(card.long(), exact)}")
        if not (torch.equal(card, host) and torch.equal(card.long(), exact)):
            fail(f"{phase}: conv_init's int32 product differs between the "
                 "card, the CPU and int64")
        noise = 100.0 * torch.randn(
            (VISION_BATCH - len(rows),) + tuple(x.shape[1:]),
            generator=torch.Generator(device=dev).manual_seed(31),
            device=dev)
        with torch.inference_mode():
            alone = qf(qp, x)
            mixed = qf(qp, torch.cat([x, noise]))[:len(rows)]
        same = torch.equal(alone, mixed)
        err = float((alone - mixed).abs().max() / alone.abs().max())
        print(f"{phase}: {len(rows)} rows alone against the same rows among "
              f"{len(noise)} outlier neighbours: bit-equal {same}, max "
              f"|diff| {err:.3e}")
        if err > CUT_RTOL:
            fail(f"{phase}: a row's features depend on its neighbours")


def stages_phase(torch, guard, images, texts, r29) -> None:
    """Phase 32: the ``ImageTransformer`` chain and ``UnrollImage`` on the
    card against ``device="cpu"``; ``save_converted`` and
    ``ModelDownloader`` by name against phase 29's model; a
    ``TextEncoderBase`` checkpoint by name, plain and quantized."""
    import shutil
    import tempfile
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.dl import TextEncoderFeaturizer
    from mmlspark_torch.featurize import TokenIdEncoder
    from mmlspark_torch.image import (ImageFeaturizer, ImageTransformer,
                                      UnrollImage)
    from mmlspark_torch.models import (LoadedModel, ModelDownloader,
                                       cosine_fidelity, get_model,
                                       save_converted)
    phase = "phase 32"
    df = DataFrame({"image": images})
    chain = ImageTransformer(inputCol="image", outputCol="t") \
        .resize(224, 224).crop(8, 8, 200, 200).colorFormat("bgr2rgb") \
        .flip(1).blur(3, 3).gaussianKernel(5, 0.0) \
        .threshold(200.0, 255.0, "trunc")
    unroll = UnrollImage(inputCol="t")
    store = tempfile.mkdtemp(prefix="vision_models_")
    before = os.environ.get("MMLSPARK_TPU_MODEL_DIR")
    try:
        with guard(phase):
            unroll.transform(chain.transform(df))
            times = []
            for _ in range(VISION_RUNS):
                t0 = time.perf_counter()
                card = unroll.transform(chain.transform(df))["unrolled"]
                times.append(time.perf_counter() - t0)
            s = float(np.median(times))
            print(f"{phase}: ImageTransformer (resize, crop, colorFormat, "
                  f"flip, blur, gaussianKernel, threshold) + UnrollImage "
                  f"{card.shape}: {s:.4f} s, {len(images) / s:,.1f} "
                  "images/s")
            chain.setDevice("cpu")
            unroll.setDevice("cpu")
            t0 = time.perf_counter()
            host = unroll.transform(chain.transform(df))["unrolled"]
            print(f"{phase}: the same on device='cpu' in "
                  f"{time.perf_counter() - t0:.2f} s")
            hold_rows(phase, "chain + UnrollImage, card against CPU", card,
                      host, CHAIN_RTOL)

            save_converted(r29["bf16"], "ResNet50", store)
            os.environ["MMLSPARK_TPU_MODEL_DIR"] = store
            t0 = time.perf_counter()
            by_name = ImageFeaturizer(modelName="ResNet50",
                                      miniBatchSize=VISION_BATCH) \
                .transform(df)["features"]
            same = np.array_equal(by_name, r29["features"])
            print(f"{phase}: save_converted + ImageFeaturizer("
                  f"modelName='ResNet50') in {time.perf_counter() - t0:.2f} "
                  f"s: features bit-equal to phase 29's {same}")
            if not same:
                fail(f"{phase}: the model reloaded by name gives other "
                     "features")

            schema = get_model("TextEncoderBase")
            enc = schema.builder(generator=torch.Generator().manual_seed(32))
            save_converted(enc, "TextEncoderBase", store)
            docs = np.asarray([" ".join(t.split()[:64 + i % 64])
                               for i, t in enumerate(texts)], object)
            ids = TokenIdEncoder(maxLength=schema.input_size,
                                 vocabSize=32768).transform(
                DataFrame({"text": docs}))
            kw = dict(seqChunk=schema.input_size)
            named = TextEncoderFeaturizer(modelName="TextEncoderBase", **kw) \
                .transform(ids)["features"]
            direct = TextEncoderFeaturizer(model=LoadedModel(schema, enc),
                                           **kw).transform(ids)["features"]
            f32 = ModelDownloader().download_by_name(
                "TextEncoderBase", dtype="float32")
            ref = TextEncoderFeaturizer(model=f32, **kw).transform(ids)[
                "features"]
            stage = TextEncoderFeaturizer(modelName="TextEncoderBase",
                                          quantize=True, **kw)
            q = stage.transform(ids)["features"]
            t0 = time.perf_counter()
            stage.transform(ids)
            q_s = time.perf_counter() - t0
            cos = cosine_fidelity(q, ref)
            print(f"{phase}: TextEncoderFeaturizer(modelName="
                  f"'TextEncoderBase') on {len(docs)} rows of "
                  f"{schema.input_size}: bit-equal to model= "
                  f"{np.array_equal(named, direct)}; quantize=True "
                  f"{q_s:.4f} s, mean cosine against f32 {cos:.6f} (floor "
                  f"{QUANT_COS_MIN})")
            if not np.array_equal(named, direct) or cos < QUANT_COS_MIN:
                fail(f"{phase}: TextEncoderBase by name or quantized")
    finally:
        if before is None:
            os.environ.pop("MMLSPARK_TPU_MODEL_DIR", None)
        else:
            os.environ["MMLSPARK_TPU_MODEL_DIR"] = before
        shutil.rmtree(store, ignore_errors=True)


def vision_phases(torch, k1, k2, k3, dev, texts, args) -> dict:
    """Phases 29-32. Returns the launches each kernel counter read over the
    group, summed over the phases' guards (which fail on any launch)."""
    totals = {}

    def guard(phase):
        return VisionGuard(k1, k2, k3, phase, totals)
    t0 = time.perf_counter()
    images = vision_images()
    print(f"vision: {len(images)} seeded uint8 BGR images of {VISION_SRC} x "
          f"{VISION_SRC} in {time.perf_counter() - t0:.2f} s")
    with Phase("phase 29"):
        r29 = backbone_phase(torch, guard, dev, images, args,
                             "ResNet50", "phase 29")
    with Phase("phase 30"):
        backbone_phase(torch, guard, dev, images, args, "ViT_B_16",
                       "phase 30")
        torch.cuda.empty_cache()
    with Phase("phase 31"):
        quantized_phase(torch, guard, dev, images, r29)
    with Phase("phase 32"):
        stages_phase(torch, guard, images, texts, r29)
    print(f"vision (phases 29-32): {time.perf_counter() - t0:.1f} s")
    return totals


def kernel_events(trace_path: str) -> tuple:
    """The kernel events of an exported ``torch.profiler`` trace, the
    user-annotation events (``record_function`` regions), the names of
    every event and what the profiler dropped: ``(kernels, annotations,
    names, (lost, launches))``, where ``launches`` counts the kernel-launch
    API records and ``lost`` those whose kernel record (same correlation
    id) is missing."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    notes = [e for e in events if e.get("cat") == "user_annotation"
             and "dur" in e]
    seen = {e.get("args", {}).get("correlation") for e in kernels}
    launches = [e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "LaunchKernel" in str(e.get("name"))]
    lost = sum(1 for e in launches
               if e.get("args", {}).get("correlation") not in seen)
    return kernels, notes, {e.get("name") for e in events}, (lost,
                                                              len(launches))


def region_share(kernels, region) -> dict:
    """What a capture shows for one annotated region (its user annotation
    event): kernels whose start falls inside it, their device time, the
    region's wall and the busy share, and the three longest kernels."""
    t0, t1 = region["ts"], region["ts"] + region["dur"]
    inside = [e for e in kernels if t0 <= e["ts"] <= t1]
    busy_us = sum(e.get("dur", 0) for e in inside)
    by_name: dict = {}
    for e in inside:
        short = re.split(r"[<(]", re.sub(r"^void |\(anonymous namespace\)::",
                                         "", e["name"]))[0]
        by_name[short] = by_name.get(short, 0) + e.get("dur", 0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return {"kernels": len(inside), "device_ms": busy_us / 1e3,
            "wall_ms": (t1 - t0) / 1e3, "busy": busy_us / max(t1 - t0, 1),
            "top": [(n, round(us / 1e3, 3)) for n, us in top]}


def obs_phase(torch, k1, k2, k3, dev, card) -> None:
    """Phase 33: the observability plane on the card, over phases 3, 8 and
    11's data and models (module docstring, item 33)."""
    import gc
    import shutil
    import statistics
    import tempfile

    from mmlspark_torch.dl import mask_batch, masked_xent
    from mmlspark_torch.dl.train import TrainState, make_train_step
    from mmlspark_torch.lightgbm import LightGBMClassifier
    from mmlspark_torch.obs import (CompileTracker, MetricsRegistry,
                                    SpanCollector, XprofCaptures,
                                    compile_tracker, device_memory_stats,
                                    memory_profiler, peak_spec, registry,
                                    step_profiler, tracer)
    from mmlspark_torch.obs.attribution import count_cost
    from mmlspark_torch.stages import Timer
    phase = "phase 33"
    # the host-only scrape runs beside the rest (a process takes seconds to
    # start), with the card visible
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    scrape = subprocess.Popen(
        [sys.executable, "-c", HOST_SCRAPE], env=env, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        df, kw = OBS["gbdt_df"], OBS["gbdt_kw"]
        iters = kw["numIterations"]

        # ---- GBDT spans: the fit under a collector, beside it untraced
        rounds_h = registry.histogram("lightgbm_boosting_round_seconds")
        plain, restore = counting_plain(k1)
        traced, untraced = [], []
        try:
            for run in range(2):
                before = rounds_h.count(mode="fused")
                k1.hist_cuda.launches = 0
                t0 = time.perf_counter()
                with SpanCollector() as col:
                    LightGBMClassifier(**kw).fit(df)
                    torch.cuda.synchronize()
                traced.append(time.perf_counter() - t0)
                spans = col.spans()
                fits = [sp for sp in spans if sp["name"] == "lightgbm.fit"]
                rounds = [sp for sp in spans
                          if sp["name"] == "boosting_round"]
                hist_n = rounds_h.count(mode="fused") - before
                if (len(fits) != 1 or len(rounds) != iters
                        or hist_n != iters or any(
                            r["parentId"] != fits[0]["spanId"]
                            for r in rounds)):
                    fail(f"{phase}: {len(fits)} lightgbm.fit span(s), "
                         f"{len(rounds)} boosting_round, round histogram "
                         f"+{hist_n}: expected 1 fit with {iters} rounds "
                         f"under it and +{iters}")
                rsum = sum(r["seconds"] for r in rounds)
                if rsum > fits[0]["seconds"]:
                    fail(f"{phase}: the rounds' {rsum:.4f} s exceed the "
                         f"fit's {fits[0]['seconds']:.4f} s")
                if k1.hist_cuda.launches != OBS["gbdt_launches"] or plain[0]:
                    fail(f"{phase}: the traced fit launched K1 "
                         f"{k1.hist_cuda.launches} times (phase 3: "
                         f"{OBS['gbdt_launches']}) with {plain[0]} plain "
                         "calls")
                t0 = time.perf_counter()
                LightGBMClassifier(**kw).fit(df)
                torch.cuda.synchronize()
                untraced.append(time.perf_counter() - t0)
        finally:
            restore()
        print(f"{phase}: GBDT fit under a SpanCollector: 1 lightgbm.fit "
              f"span ({fits[0]['attrs']}), {len(rounds)} boosting_round "
              f"children, rounds {rsum:.4f} s of the fit's "
              f"{fits[0]['seconds']:.4f} s, round histogram +{hist_n}, "
              f"{OBS['gbdt_launches']} K1 launches, 0 plain calls; fit "
              f"traced {statistics.median(traced):.3f} s, untraced "
              f"{statistics.median(untraced):.3f} s (medians of 2, "
              f"{', '.join(f'{t:.3f}' for t in traced + untraced)} s; "
              f"no limit) [{card}]")

        # ---- a capture around one warm fit and one decode round
        eng = OBS["engine"]
        vocab = TEXT_SHAPE["vocab"]
        rng = np.random.default_rng(33)
        prompts = [rng.integers(2, vocab, size=GEN_T) for _ in range(16)]
        wrappers = (k1.hist_cuda, k3.paged_decode_cuda, k3.paged_cuda)
        for attempt in range(1, CAPTURE_ATTEMPTS + 1):
            before = [(fn.launches, getattr(fn, "combine_launches", 0))
                      for fn in wrappers]
            root = tempfile.mkdtemp(prefix="chip_smoke_xprof_")
            t0 = time.perf_counter()
            with XprofCaptures(root=root).region("fit_and_decode") as cap:
                with tracer.span("chip_smoke.fit", device=True):
                    LightGBMClassifier(**kw).fit(df)
                    torch.cuda.synchronize()
                with tracer.span("chip_smoke.decode_round", device=True):
                    for i, p in enumerate(prompts):
                        eng.submit(f"obs-{attempt}-{i}", p, 8)
                    eng.run_until_drained()
                    torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            (k1_n, _), (dec_n, dec_c), (win_n, win_c) = [
                (fn.launches - b[0],
                 getattr(fn, "combine_launches", 0) - b[1])
                for fn, b in zip(wrappers, before)]
            t0 = time.perf_counter()
            kernels, notes, names, (lost, n_launch) = kernel_events(
                cap["trace"])
            parse_s = time.perf_counter() - t0
            size_mb = os.path.getsize(cap["trace"]) / 1e6

            def n_of(*keys):
                return sum(1 for e in kernels if any(k in e["name"]
                                                     for k in keys))
            got = {"hist_partial": n_of("hist_partial"),
                   "hist_reduce": n_of("hist_reduce"),
                   "paged_decode": n_of("paged_decode"),
                   "paged_combine": n_of("paged_combine"),
                   "paged window": n_of("paged_fwd", "paged_f32")}
            want = {"hist_partial": k1_n, "hist_reduce": k1_n,
                    "paged_decode": dec_n, "paged_combine": dec_c + win_c,
                    "paged window": win_n}
            if cap["device"] and got == want and k1_n and dec_n:
                break
            shutil.rmtree(root, ignore_errors=True)
            msg = (f"{phase}: capture {attempt} of {CAPTURE_ATTEMPTS}: the "
                   f"capture's kernel events {got}, expected {want} from the "
                   f"wrappers' launch deltas (device activity "
                   f"{cap['device']}); the profiler kept {n_launch} "
                   f"kernel-launch records, {lost} of them without their "
                   f"kernel record, and {len(kernels)} kernel records")
            short = all(got[k] <= want[k] for k in want)
            if attempt == CAPTURE_ATTEMPTS or not (
                    cap["device"] and k1_n and dec_n and short):
                fail(msg)
            print(msg + ": the profiler dropped records; retaken")
        missing = {"chip_smoke.fit", "chip_smoke.decode_round"} - names
        if missing:
            fail(f"{phase}: the device=True spans {sorted(missing)} are not "
                 "in the capture")
        regions = {e["name"]: e for e in notes}
        fit_r = region_share(kernels, regions["chip_smoke.fit"])
        dec_r = region_share(kernels, regions["chip_smoke.decode_round"])
        shutil.rmtree(root, ignore_errors=True)
        print(f"{phase}: torch.profiler capture (XprofCaptures.region, CPU "
              f"and CUDA activity) around one warm fit and one decode round "
              f"(16 prompts of {GEN_T}, 8 new each) of phase 11's engine: "
              f"{capture_s:.2f} s with the export, trace {size_mb:.1f} MB "
              f"parsed in {parse_s:.2f} s; kernel events {got} = the "
              f"wrappers' launch deltas (K1 {k1_n} x 2 kernels, K3 decode "
              f"{dec_n} + combine {dec_c + win_c}, window {win_n}); capture "
              f"{attempt} of up to {CAPTURE_ATTEMPTS}, {lost} of its "
              f"{n_launch} kernel-launch records without a kernel record "
              f"[{card}]")
        for label, r in (("fit", fit_r), ("decode round", dec_r)):
            print(f"{phase}: capture, {label}: {r['kernels']} kernels, "
                  f"{r['device_ms']:.3f} ms of device time in "
                  f"{r['wall_ms']:.3f} ms of wall (busy {r['busy']:.3f}); "
                  f"longest {r['top']} [{card}]")

        # ---- device memory against the allocator, at one moment
        torch.cuda.synchronize()
        stats = device_memory_stats()
        alloc = torch.cuda.memory_allocated(0)
        total = torch.cuda.mem_get_info(0)[1]
        peak = torch.cuda.max_memory_allocated(0)
        mine = [r for r in stats if r["device"] == "0"]
        if (len(mine) != 1 or mine[0]["bytes_in_use"] != alloc
                or mine[0]["bytes_limit"] != total
                or mine[0]["peak_bytes_in_use"] != peak):
            fail(f"{phase}: device_memory_stats() {stats} against "
                 f"memory_allocated {alloc}, max_memory_allocated {peak}, "
                 f"mem_get_info total {total}")
        memory_profiler.update()
        gauge = registry.snapshot().get(
            'mem_hbm_bytes_in_use{device="0"}')
        if gauge != alloc:
            fail(f"{phase}: mem_hbm_bytes_in_use {gauge}, allocated {alloc}")
        print(f"{phase}: device_memory_stats() = memory_allocated "
              f"{alloc:,} B, peak {peak:,} B, limit {total:,} B "
              f"(mem_get_info) [{card}]")

        # ---- phase 8's masked-LM step: counted on both routes, and MFU
        model, ids = OBS["masked_lm"], OBS["masked_lm_ids"]
        opt = torch.optim.AdamW(model.parameters(), lr=1e-4)
        state = TrainState(model=model, optimizer=opt)
        step = make_train_step(model, opt, loss_fn=masked_xent,
                               fetch="logits")
        rng = np.random.default_rng(8)
        rows = ids[rng.integers(0, len(ids), size=TRAIN_BATCH)]
        x, y = (torch.from_numpy(a).to(dev) for a in mask_batch(
            rows, rng, mask_id=TEXT_SHAPE["vocab"] - 1))
        state, _ = step(state, x, y)                 # AdamW's state
        torch.cuda.synchronize()
        launches = (k2.flash_lse_cuda.launches, k2.flash_dq_cuda.launches,
                    k2.flash_dkv_cuda.launches)
        with count_cost() as card_count:
            state, _ = step(state, x, y)
            torch.cuda.synchronize()
        depth = TEXT_SHAPE["depth"]
        ran = tuple(fn.launches - b for fn, b in zip(
            (k2.flash_lse_cuda, k2.flash_dq_cuda, k2.flash_dkv_cuda),
            launches))
        if ran != (depth, depth, depth):
            fail(f"{phase}: the counted step launched K2b/K2d/K2e {ran}, "
                 f"expected {depth} each")
        real_route = k2._route
        k2._route = lambda q, impl: False
        try:
            with count_cost() as plain_count:
                state, _ = step(state, x, y)
                torch.cuda.synchronize()
        finally:
            k2._route = real_route
        card_c = (card_count.flops, card_count.bytes)
        plain_c = (plain_count.flops, plain_count.bytes)
        if card_c != plain_c or card_count.flops <= 0:
            fail(f"{phase}: the step counts {card_c} (FLOPs, bytes) "
                 f"through the kernels and {plain_c} through the plain "
                 "versions")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            state, _ = step(state, x, y)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        step_s = statistics.median(times)
        spec = peak_spec()
        mfu = step_profiler.record_mfu("pretrain_masked_lm",
                                       card_count.flops, step_s)
        if spec.platform != "gpu-h100" or not 0 < mfu <= MFU_MAX:
            fail(f"{phase}: MFU {mfu} against {spec} (expected the "
                 f"gpu-h100 row and (0, {MFU_MAX}])")
        print(f"{phase}: pretrain_masked_lm step (batch {TRAIN_BATCH} x "
              f"T={TEXT_T}, {TEXT_SHAPE}, AdamW): "
              f"{card_count.flops / 1e12:.4f} TFLOP and "
              f"{card_count.bytes / 1e9:.3f} GB counted through the kernels"
              f" = through the plain versions on the card (the kernels' "
              f"formulas {card_count.analytic_flops / 1e12:.4f} TFLOP of "
              f"it); step {step_s:.4f} s (median of 5: "
              f"{', '.join(f'{t:.4f}' for t in times)}); MFU {mfu:.4f} "
              f"against {spec.peak_flops / 1e12:.0f} TFLOP/s "
              f"({spec.platform}); roofline "
              f"{spec.roofline_seconds(*card_c) * 1e3:.3f} ms [{card}]")
        del state, opt, step, x, y

        # ---- a Timer around phase 3's model's transform (the step's
        # tensors collected first, so no collection lands in the window)
        gc.collect()
        torch.cuda.synchronize()
        timer = Timer(stage=OBS["gbdt_model"])
        timer.transform(df)                          # warm
        t0 = time.perf_counter()
        timer.transform(df)
        wall = time.perf_counter() - t0
        split = timer.lastDispatch + timer.lastDevice
        if (not timer.lastSynced or timer.lastDevice <= 0
                or abs(split - wall) > TIMER_WALL_SHARE * wall):
            fail(f"{phase}: Timer synced {timer.lastSynced}, dispatch "
                 f"{timer.lastDispatch:.6f} s + device "
                 f"{timer.lastDevice:.6f} s against {wall:.6f} s of wall")
        print(f"{phase}: Timer(LightGBMClassificationModel).transform of "
              f"{len(df['label']):,} rows: dispatch "
              f"{timer.lastDispatch:.6f} s + device {timer.lastDevice:.6f} "
              f"s = {split:.6f} s of {wall:.6f} s wall, synced [{card}]")

        # ---- the engine's compiles after round 3, and what tracking costs
        # a decode step: the same wrapper (a tracker of its own) around a
        # bare function, on the engine's step arguments, against the bare
        # function, in alternating runs
        print(f"{phase}: phase 11's compile_tracker after round 3: "
              f"{OBS['engine_compiles']}; signatures after mark_steady: "
              f"{OBS['engine_late'] or 'none'}")
        dec = eng.decoder
        step_args = (dec.kv.block_rows([None] * dec.slots, dec.max_blocks),
                     dec.last, dec.ptr, dec.end, dec.active.copy())

        def bare(*_):
            return None
        tracked = CompileTracker(registry=MetricsRegistry()).track(
            bare, name="chip_smoke_probe")
        calls, costs = 2540, []
        for _ in range(5):
            run_s = []
            for fn in (bare, tracked):
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn(*step_args)
                run_s.append(time.perf_counter() - t0)
            costs.append((run_s[1] - run_s[0]) / calls * 1e6)
        cost_us = float(np.median(costs))
        print(f"{phase}: compile_tracker's own cost per decode step: "
              f"{cost_us:.3f} us (median of 5 alternating runs of "
              f"{calls:,} calls on the engine's step arguments, host clock: "
              f"{', '.join(f'{c:.3f}' for c in costs)} us), "
              f"{cost_us / 1e3 / OBS['engine_step_ms'] * 100:.4f} % of "
              f"round 3's {OBS['engine_step_ms']:.3f} ms per step [{card}]")

        # ---- the host-only scrape
        out, err = scrape.communicate(timeout=120)
    finally:
        if scrape.poll() is None:
            scrape.kill()
            scrape.wait()
    if scrape.returncode != 0:
        fail(f"{phase}: the host-only scrape failed: {err[-2000:]}")
    got = json.loads(out.strip().splitlines()[-1])
    host, card = got["host"], got["card"]
    if host != {"stats": [], "initialized": False, "mem_gauges": False}:
        fail(f"{phase}: a host-only process's scrape gave {host}: expected "
             "no stats, no mem_hbm_ gauges and CUDA uninitialized")
    if not (card["initialized"] and card["mem_gauges"] and card["stats"]
            and card["stats"][0].get("bytes_in_use", 0) >= 4096):
        fail(f"{phase}: after torch.cuda.init() and a tensor on the card the "
             f"same scrape gave {card}: the host-only check cannot fail")
    print(f"{phase}: a host-only process's scrape (card visible): "
          "device_memory_stats() [], no mem_hbm_ gauge, "
          "torch.cuda.is_initialized() False; after torch.cuda.init() and a "
          f"4,096-byte tensor the same scrape: initialized True, "
          f"{card['stats']}")


# phase 34: the control plane (ROADMAP.md §1 item 9b) serving BERT-base on
# K2a behind the scheduler, as the reference's overload scenario
# (mmlspark_tpu/testing/benchmarks.py overload_scenario) with a real executor
CONTROL_SERVICE = "control-bert"
CONTROL_REQUESTS = 1500
CONTROL_TOKENS = (64, 512)    # WordPiece tokens a request, uniform
CONTROL_BATCH = 32            # the executor's next_batch(max_batch=...)
CONTROL_RATE_FACTOR = 2.0     # offered load over the sustainable rate
CONTROL_RATE_BATCHES = 8      # full warm batches timed for that rate
CONTROL_DEADLINE = 0.2        # the reference overload scenario's deadline_s
CONTROL_MAX_QUEUE = 512       # 16 full batches (the reference: 8 of 8)
CONTROL_GOLD_SHARE = 0.5      # requests drawn for the gold tenant
CONTROL_BE_QUEUE_SHARE = 0.25  # best-effort's queue share (the reference's)
CONTROL_SEED = 34
# the served rows against the dense route (raw floor, centred floor, max
# |diff|): phase 24's floors; its max |diff| of 5e-3 was read over 32 rows,
# and over this traffic's ~750-1,500 rows every reading exceeds it. Over 4
# weight and 4 request seeds (tools/control_bf16_agreement.py, NVIDIA H100
# 80GB HBM3, 700 W) K2a against dense read raw >= 0.9999971, centred >=
# 0.9997525, max |diff| 0.0072-0.0087, each bf16 route 0.0135-0.0168 from
# float32 (K2a no farther than dense), and the key mask dropped centred <=
# -0.066, max |diff| >= 1.45: max |diff| is held at 1.4x the worst reading.
CONTROL_POOLED_LIMITS = BERT_BF16_POOLED_LIMITS[:2] + (0.0125,)
# every shed reason of the reference's admission, expiry and tenancy
SHED_REASONS = frozenset({"queue_full", "deadline", "inflight", "expired",
                          "tenant_rate", "tenant_inflight", "tenant_queue"})


def padded_rows(rows, width=None) -> np.ndarray:
    """Token rows of different lengths as one [n, T] id matrix, zero-padded
    to ``width`` or, as ``TextEncoderFeaturizer`` pads them, to a multiple
    of its ``seqChunk`` (128)."""
    T = width or -(-max(len(r) for r in rows) // 128) * 128
    out = np.zeros((len(rows), T), np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


class ControlRequest:
    """One single-document request: its token ids, its tenant, the
    latch-once reply the scheduler's ``on_done`` hook rides on, and what
    the phase reads back (``status``, ``reason``, ``retry_after``, the
    reply time)."""

    def __init__(self, rid: int, tokens: np.ndarray, tenant: str):
        self.rid = rid
        self.tokens = tokens
        self.tenant = tenant
        self.on_done = None
        self.submitted = self.done_at = None
        self.status = self.reason = self.retry_after = None

    def finish(self, status: int, reason=None, retry_after=None) -> None:
        if self.status is not None:
            fail(f"phase 34: request {self.rid} answered twice")
        self.status, self.reason, self.retry_after = \
            status, reason, retry_after
        self.done_at = time.monotonic()
        cb, self.on_done = self.on_done, None
        if cb is not None:
            cb()


def control_traffic(texts, seed=CONTROL_SEED):
    """The phase's traffic: 256 seeded windows of 512 words from ``texts``
    through WordPiece, then ``CONTROL_REQUESTS`` single documents of 64-512
    tokens (a window cut to its drawn length, ``[CLS]`` first and ``[SEP]``
    last), whether each is the gold tenant's, and their Poisson arrival
    offsets in units of one over the rate. Returns ``(tokens, gold,
    arrivals, windows)``."""
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.featurize import WordPieceTokenizerModel
    T = BERT_BASE["max_len"]
    rng = np.random.default_rng(seed)
    starts = [(int(d), int(rng.integers(0, len(texts[d].split()) - T)))
              for d in rng.integers(0, len(texts), 256)]
    vocab = wordpiece_vocab(texts)
    tok = WordPieceTokenizerModel.from_vocab(vocab, maxLength=T,
                                             inputCol="text")
    windows = np.asarray(tok.transform(DataFrame({"text": np.asarray(
        [" ".join(texts[d].split()[o:o + T]) for d, o in starts],
        object)}))["tokens"], np.int32)
    if (windows == 0).any():
        fail("phase 34: a 512-word window gave fewer than 512 tokens")
    n = CONTROL_REQUESTS
    lengths = rng.integers(CONTROL_TOKENS[0], CONTROL_TOKENS[1] + 1, n)
    picks = rng.integers(0, len(windows), n)
    gold = rng.random(n) < CONTROL_GOLD_SHARE
    gaps = rng.exponential(1.0, n)
    tokens = []
    for L, p in zip(lengths, picks):
        row = windows[p][:L].copy()
        row[-1] = vocab.index("[SEP]")
        tokens.append(row)
    return tokens, gold, np.cumsum(gaps) - gaps[0], windows


def serve_schedule(sched, execute, tokens, gold, arrivals, rate, tenants):
    """Offer ``tokens`` to ``sched`` on the seeded arrival schedule at
    ``rate`` requests a second (the submitting thread wakes at most once a
    millisecond and submits what is due as one burst) while one executor
    thread pulls batches and runs ``execute``. Returns the requests, the
    executed batches, what was seen at intake and at dispatch, and the
    seconds the offer took."""
    import threading
    from mmlspark_torch.sched import Shed
    from mmlspark_torch.sched.policy import now

    reqs = [ControlRequest(i, t, tenants[0] if g else tenants[1])
            for i, (t, g) in enumerate(zip(tokens, gold))]
    seen = {"depth": 0, "late": 0, "admitted": 0, "intake": {}}
    batches = []
    stop = threading.Event()
    errors = []

    def executor():
        try:
            while not (stop.is_set() and sched.qsize() == 0):
                batch = sched.next_batch(max_batch=CONTROL_BATCH,
                                         max_wait=0.05)
                if not batch:
                    continue
                t_dispatch = now()
                seen["late"] += sum(1 for r in batch
                                    if getattr(r, "deadline", None)
                                    is not None and r.deadline < t_dispatch)
                batches.append(execute(batch))
                for r in batch:
                    r.finish(200)
                seen["depth"] = max(seen["depth"], sched.qsize())
        except BaseException as e:      # surfaced by the caller
            errors.append(e)

    worker = threading.Thread(target=executor, daemon=True)
    worker.start()
    t0 = time.perf_counter()
    i = 0
    while i < len(reqs):
        due = (time.perf_counter() - t0) * rate
        while i < len(reqs) and arrivals[i] <= due:
            r = reqs[i]
            r.submitted = time.monotonic()
            try:
                sched.submit(r, tenant=r.tenant)
                seen["admitted"] += 1
            except Shed as e:
                r.finish(e.status, e.reason, e.retry_after)
                seen["intake"][e.reason] = seen["intake"].get(e.reason, 0) + 1
            seen["depth"] = max(seen["depth"], sched.qsize())
            i += 1
        if i < len(reqs):
            # a tick of at least a millisecond: the due requests go in as
            # one burst
            time.sleep(max((arrivals[i] - due) / rate, 1e-3))
    offered_s = time.perf_counter() - t0
    stop.set()
    sched.wake()
    worker.join(timeout=120)
    if worker.is_alive() or errors:
        fail(f"phase 34: the executor thread "
             f"{'hung' if worker.is_alive() else f'raised {errors[0]!r}'}")
    return reqs, batches, seen, offered_s


def control_phase(torch, k2, dev, bw, flush, texts, card,
                  need_record: bool) -> dict:
    """Phase 34: the control plane on the card (module docstring, item
    34). Returns K2a's launches on the path and, when ``need_record``, its
    record at this path's shape for the kernels line."""
    import os
    import shutil
    import tempfile
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.dl import TextEncoderFeaturizer, TrainState
    from mmlspark_torch.dl.checkpoint import CheckpointManager
    from mmlspark_torch.models import (LoadedModel, bert_encoder_from_torch,
                                       register_bert_encoder)
    from mmlspark_torch.obs import cost_attribution, feature_log, registry
    from mmlspark_torch.perf.costmodel import enabled, shared_cost_model
    from mmlspark_torch.resilience import FaultRule, InjectedDrop, faults
    from mmlspark_torch.sched import (BEST_EFFORT, GOLD, RequestScheduler,
                                      ServiceTimeEstimator, Tenancy,
                                      TenantQuota, bucket_of)
    from mmlspark_torch.testing.benchmarks import _pctl

    if not enabled():
        fail("phase 34: MMLSPARK_TPU_COSTMODEL=0 turns the cost model off")
    T = BERT_BASE["max_len"]
    H, W, depth = BERT_BASE["heads"], BERT_BASE["width"], BERT_BASE["depth"]
    tenants = ("acme", "free")          # gold, best effort

    t0 = time.perf_counter()
    tokens, gold, arrivals, windows = control_traffic(texts)
    print(f"phase 34: WordPiece over {len(windows)} windows of {T} words "
          f"in {time.perf_counter() - t0:.2f} s; {len(tokens)} requests of "
          f"{min(map(len, tokens))}-{max(map(len, tokens))} tokens, "
          f"{int(gold.sum())} gold")

    # the model: phase 24's BERT-base, bf16, through K2a
    schema = register_bert_encoder("BertBaseControl", seq_len=T, **BERT_BASE)
    module = bert_encoder_from_torch(
        bert_state_dict(torch), config={"num_attention_heads": H},
        dtype=torch.bfloat16).to(dev)
    kw = dict(model=LoadedModel(schema, module), inputCol="tokens",
              seqChunk=128)
    stage = TextEncoderFeaturizer(attentionImpl="pallas", **kw)

    def frame(rows):
        col = np.empty(len(rows), object)
        col[:] = rows
        return DataFrame({"tokens": col})

    sched_box = {}
    cm = shared_cost_model()
    # the service's analytic cost per execution, as the reference's
    # serving path reads it from the attribution table (schema v6)
    cost_attribution.record_call(
        "bert-base-32x512", stage.transform, frame(
            [windows[i] for i in range(CONTROL_BATCH)]),
        service=CONTROL_SERVICE)
    a_flops, a_bytes = cost_attribution.service_cost(CONTROL_SERVICE)
    # the warm passes feed the service's EWMA (registry state, shared with
    # the scheduler's estimator below), as the reference primes it
    warm_est = ServiceTimeEstimator(CONTROL_SERVICE)

    def execute(batch, record=True):
        """The executor's work on one batch: the featurizer on the card,
        the estimator fed the measured time, one FeatureLog row."""
        sched = sched_box.get("sched")
        est = sched.estimator if sched is not None else warm_est
        n = len(batch)
        rows = [r.tokens for r in batch]
        pred_model = cm.predict_batch_ms(CONTROL_SERVICE, n, count=False)
        pred_ewma = est._ewma_estimate(n)
        t0 = time.perf_counter()
        out = stage.transform(frame(rows))["features"]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if record:
            est.observe(n, seconds)
            waits = [getattr(r, "queue_wait", None) or 0.0 for r in batch]
            feature_log.record(
                service=CONTROL_SERVICE, route="/", batch=n,
                bucket=bucket_of(n), padded_batch=bucket_of(n),
                queue_depth=sched.qsize() if sched is not None else 0,
                queue_ms=round(1e3 * sum(waits) / n, 4),
                execute_ms=round(seconds * 1e3, 4),
                entity_bytes=4 * sum(len(r) for r in rows),
                compiled_segments=None, analytic_flops=a_flops,
                analytic_bytes=a_bytes, trace_id=None)
        return {"rows": rows, "pooled": out, "seconds": seconds,
                "model_ms": pred_model, "ewma_ms": None if pred_ewma is None
                else pred_ewma * 1e3}

    # warm every shape the executor can meet (batch 1-32, T a multiple of
    # 128) twice; the second pass lands as FeatureLog rows
    t0 = time.perf_counter()
    by_chunk = {c: np.flatnonzero(np.maximum(
        (np.asarray([len(t) for t in tokens]) + 127) // 128, 1) == c)
        for c in range(1, T // 128 + 1)}
    for record in (False, True):
        for c, idx in by_chunk.items():
            for n in range(1, CONTROL_BATCH + 1):
                execute([ControlRequest(i, tokens[i], "") for i in idx[:n]],
                        record=record)
    warm_s = time.perf_counter() - t0
    full = [execute([ControlRequest(i, tokens[i], "")
                     for i in range(j * CONTROL_BATCH,
                                    (j + 1) * CONTROL_BATCH)],
                    record=False)["seconds"]
            for j in range(CONTROL_RATE_BATCHES)]
    full_s = float(np.median(full))
    rate = CONTROL_BATCH / full_s
    cm.maybe_refresh(min_new=0)
    fit = cm._models.get((CONTROL_SERVICE, ""))
    if fit is None:
        fail("phase 34: the cost model did not fit on the warm pass's rows")
    print(f"phase 34: warmed {CONTROL_BATCH * len(by_chunk)} batch shapes "
          f"twice in {warm_s:.2f} s; sustainable rate {rate:,.1f} seqs/s "
          f"(full batches of {CONTROL_BATCH}: median "
          f"{full_s * 1e3:.3f} ms over {CONTROL_RATE_BATCHES}); cost model "
          f"fitted on {fit['n']} FeatureLog rows of the service, train MAE "
          f"{fit['train_mae_ms']:.3f} ms")

    def scheduler(cls):
        tenancy = Tenancy(CONTROL_SERVICE, quotas={
            tenants[0]: TenantQuota(tier=GOLD),
            tenants[1]: TenantQuota(tier=BEST_EFFORT,
                                    queue_share=CONTROL_BE_QUEUE_SHARE)},
            tier_deadlines={"gold": 0.6, "silver": 1.2})
        shed = []

        def on_shed(item, reason, retry_after):
            shed.append(item)
            item.finish(429, reason, retry_after)
        s = cls(CONTROL_SERVICE, max_queue=CONTROL_MAX_QUEUE,
                deadline=CONTROL_DEADLINE, tenancy=tenancy, on_shed=on_shed)
        if s.estimator.cost_model is not cm:
            fail("phase 34: the scheduler did not attach the shared cost "
                 "model")
        sched_box["sched"] = s
        return s, shed

    def counts(snap):
        adm = sum(v for k, v in snap.items()
                  if k.startswith("sched_admitted_total{")
                  and f'service="{CONTROL_SERVICE}"' in k)
        shed = {}
        for k, v in snap.items():
            if k.startswith("sched_shed_total{") and \
                    f'service="{CONTROL_SERVICE}"' in k:
                reason = re.search(r'reason="([^"]+)"', k).group(1)
                shed[reason] = shed.get(reason, 0) + v
        return adm, shed

    # ---- the timed pass
    sched, shed_after = scheduler(RequestScheduler)
    before = counts(registry.snapshot())
    obs_key = ('sched_service_observations_total{bucket="32",'
               f'service="{CONTROL_SERVICE}"}}')
    ewma_before = (sched.estimator._ewma_estimate(CONTROL_BATCH),
                   registry.snapshot().get(obs_key, 0.0))
    offered_rate = CONTROL_RATE_FACTOR * rate
    k2.flash_cuda.launches = 0
    t0 = time.perf_counter()
    reqs, batches, seen, offered_s = serve_schedule(
        sched, execute, tokens, gold, arrivals, offered_rate, tenants)
    wall_s = time.perf_counter() - t0
    launches = k2.flash_cuda.launches
    after = counts(registry.snapshot())

    answered = [r for r in reqs if r.status == 200]
    intake = sum(seen["intake"].values())
    n_batches = len(batches)
    print(f"phase 34: {len(reqs)} requests offered at "
          f"{offered_rate:,.1f}/s ({CONTROL_RATE_FACTOR}x) over "
          f"{offered_s:.3f} s, done in {wall_s:.3f} s: {len(answered)} "
          f"answered, {intake} shed at intake {seen['intake']}, "
          f"{len(shed_after)} shed after queueing; {n_batches} batches of "
          f"mean size {len(answered) / max(n_batches, 1):.2f}; queue depth "
          f"max {seen['depth']} of {CONTROL_MAX_QUEUE}")
    # every request accounted for, every shed with a reason and Retry-After
    if len(answered) + intake + len(shed_after) != len(reqs) or \
            any(r.status is None for r in reqs):
        fail(f"phase 34: {len(answered)} answered + {intake} + "
             f"{len(shed_after)} shed != {len(reqs)} offered")
    for r in reqs:
        if r.status != 200 and (r.reason not in SHED_REASONS
                                or not r.retry_after or r.retry_after <= 0):
            fail(f"phase 34: request {r.rid} shed with reason {r.reason!r} "
                 f"and Retry-After {r.retry_after!r}")
    if seen["depth"] > CONTROL_MAX_QUEUE:
        fail(f"phase 34: queue depth {seen['depth']} > {CONTROL_MAX_QUEUE}")
    if seen["late"]:
        fail(f"phase 34: {seen['late']} requests dispatched after their "
             "deadline")
    reg_admitted = after[0] - before[0]
    reg_shed = {k: v - before[1].get(k, 0) for k, v in after[1].items()
                if v - before[1].get(k, 0)}
    own_shed = dict(seen["intake"])
    for r in shed_after:
        own_shed[r.reason] = own_shed.get(r.reason, 0) + 1
    print(f"phase 34: registry sched_admitted_total {reg_admitted:g}, "
          f"sched_shed_total {reg_shed}; the phase's {seen['admitted']} and "
          f"{own_shed}")
    if reg_admitted != seen["admitted"] or reg_shed != own_shed:
        fail("phase 34: the registry's sched_* series disagree with the "
             "phase's counts")
    if launches != depth * n_batches:
        fail(f"phase 34: {launches} K2a launches over {n_batches} batches: "
             f"expected {depth} a batch")
    # tenancy under overload
    share = {}
    for tenant in tenants:
        mine = [r for r in reqs if r.tenant == tenant]
        ok = [r.done_at - r.submitted for r in mine if r.status == 200]
        share[tenant] = len(ok) / max(len(mine), 1)
        lat = sorted(ok)
        print(f"phase 34: tenant {tenant} "
              f"({'gold' if tenant == tenants[0] else 'best_effort'}): "
              f"{len(mine)} offered, {len(ok)} answered "
              f"({100 * share[tenant]:.1f} %), latency p50 "
              f"{_pctl(lat, 0.5) * 1e3:.2f} ms, p99 "
              f"{_pctl(lat, 0.99) * 1e3:.2f} ms")
    if share[tenants[0]] < share[tenants[1]]:
        fail("phase 34: gold's answered share is below best effort's")

    # the service-time brains against the measured batch times
    measured = np.asarray([b["seconds"] * 1e3 for b in batches])
    full_ms = [b["seconds"] * 1e3 for b in batches
               if len(b["rows"]) == CONTROL_BATCH]
    ewma32 = sched.estimator._ewma_estimate(CONTROL_BATCH)
    print(f"phase 34: estimator EWMA for a batch of {CONTROL_BATCH}: "
          f"{ewma_before[0] * 1e3:.3f} ms before the pass, "
          f"{ewma32 * 1e3:.3f} ms after "
          f"{registry.snapshot().get(obs_key, 0.0) - ewma_before[1]:g} "
          f"observations; measured full batches median "
          f"{np.median(full_ms) if full_ms else float('nan'):.3f} ms "
          f"({len(full_ms)} of them); executor batch times p50 "
          f"{np.median(measured):.3f} ms, max {measured.max():.3f} ms")
    tail = batches[-max(n_batches // 3, 1):]
    m_err = [abs(b["model_ms"] - b["seconds"] * 1e3) for b in tail
             if b["model_ms"] is not None]
    e_err = [abs(b["ewma_ms"] - b["seconds"] * 1e3) for b in tail
             if b["ewma_ms"] is not None]
    print(f"phase 34: over the last {len(tail)} batches, cost-model MAE "
          f"{np.mean(m_err) if m_err else float('nan'):.3f} ms "
          f"({len(m_err)} priced), EWMA MAE "
          f"{np.mean(e_err) if e_err else float('nan'):.3f} ms "
          f"({len(e_err)} priced); cost model gated: "
          f"{cm.predict_batch_ms(CONTROL_SERVICE, 1, count=False) is None}")

    # every answered row against the dense route on the same batches
    dense_stage = TextEncoderFeaturizer(attentionImpl="dense", **kw)
    k2.flash_cuda.launches = 0
    dense = np.concatenate([dense_stage.transform(frame(b["rows"]))
                            ["features"] for b in batches])
    if k2.flash_cuda.launches:
        fail("phase 34: the dense route launched K2a")
    pooled = np.concatenate([b["pooled"] for b in batches])
    if pooled.shape != (len(answered), W) or not np.isfinite(pooled).all():
        fail(f"phase 34: pooled rows {pooled.shape}, "
             f"{(~np.isfinite(pooled)).sum()} non-finite")
    short = np.asarray([len(r) for b in batches for r in b["rows"]]) <= 128
    print(f"phase 34: rows of <= 128 tokens ({int(short.sum())}): max "
          f"|diff| {np.abs(pooled[short] - dense[short]).max():.4g}; longer "
          f"({int((~short).sum())}): "
          f"{np.abs(pooled[~short] - dense[~short]).max():.4g}")
    if not pooled_agreement("phase 34: served rows", pooled, dense,
                            CONTROL_POOLED_LIMITS):
        fail("phase 34: the served rows disagree with the dense route "
             "beyond the stated limits")
    no_mask = module.with_attention(
        lambda q, k, v, key_mask=None: k2.flash_cuda(q, k, v, None))
    with torch.inference_mode():
        faulty = np.concatenate([no_mask.to(dev).eval()(torch.from_numpy(
            padded_rows(b["rows"])).to(dev))["pooled"].float().cpu().numpy()
            for b in batches])
    if pooled_agreement("phase 34: planted fault (key mask dropped)",
                        faulty, dense, CONTROL_POOLED_LIMITS):
        fail("phase 34: the served-row limits pass K2a with the key mask "
             "dropped: they cannot tell a faulty attention")
    del dense_stage, no_mask

    # K2a's share of the executor's wall time: the executed batches again,
    # alone, each K2a launch between its own pair of CUDA events
    k2a_ms = []
    plain = k2.flash_cuda

    def timed(*a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = plain(*a, **k)
        end.record()
        k2a_ms.append((start, end))
        return out
    timed.launches = 0                  # the wrapper counts into it
    k2.flash_cuda = timed
    alone = []
    try:
        for b in batches:
            t0 = time.perf_counter()
            stage.transform(frame(b["rows"]))
            torch.cuda.synchronize()
            alone.append(time.perf_counter() - t0)
    finally:
        k2.flash_cuda = plain
    k2a_total = sum(s.elapsed_time(e) for s, e in k2a_ms)
    print(f"phase 34: K2a {k2a_total:.2f} ms of the executor's "
          f"{measured.sum():.2f} ms over the same {n_batches} batches "
          f"({100 * k2a_total / measured.sum():.1f} %); the batches replayed "
          f"alone: {1e3 * sum(alone):.2f} ms, p50 "
          f"{1e3 * np.median(alone):.3f} ms; {card}")

    # a planted fault: the same schedule through a scheduler whose expiry
    # check is off must break the deadline check
    class NoExpiry(RequestScheduler):
        @staticmethod
        def _expired(item, est_service=0.0):
            return False

    bad, _ = scheduler(NoExpiry)
    _, _, bad_seen, _ = serve_schedule(bad, lambda b: execute(
        b, record=False), tokens, gold, arrivals, offered_rate, tenants)
    print(f"phase 34: planted fault (expiry check off): "
          f"{bad_seen['late']} requests dispatched after their deadline")
    if not bad_seen["late"]:
        fail("phase 34: the deadline check passes a scheduler whose expiry "
             "check is off: it cannot tell a faulty scheduler")
    sched_box.clear()

    # a torn save leaves the store intact
    root = tempfile.mkdtemp(prefix="control_ckpt_")
    try:
        state = TrainState(module, torch.optim.SGD(module.parameters(),
                                                   lr=0.0), 1)
        mgr = CheckpointManager(root)
        mgr.save(state)
        first = {k: v.clone() for k, v in module.state_dict().items()}
        listing = sorted(os.listdir(root))
        with torch.no_grad():
            for p in module.parameters():
                p.add_(1.0)
        with faults(CONTROL_SEED, [FaultRule(point="checkpoint.write",
                                             kind="drop", times=1)]):
            try:
                mgr.save(state, step=2)
                fail("phase 34: the armed checkpoint.write drop did not "
                     "tear the save")
            except InjectedDrop:
                pass
        if mgr.all_steps() != [1] or sorted(os.listdir(root)) != listing:
            fail(f"phase 34: the torn save changed the store: "
                 f"{sorted(os.listdir(root))}")
        mgr.restore(target=state)
        moved = [k for k, v in module.state_dict().items()
                 if v.device != dev or not torch.equal(v, first[k])]
        if moved:
            fail(f"phase 34: restore() after the torn save differs in "
                 f"{moved[:3]}")
        print(f"phase 34: a torn save (checkpoint.write drop) raised "
              f"InjectedDrop and left steps {mgr.all_steps()}; restore() "
              f"gave back all {len(first)} tensors bit-equal on the card")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    out = {"launches": launches}
    if need_record:
        biggest = max((b["rows"] for b in batches), key=len)
        out["record"] = {"name": "flash_control", "route": "cuda",
                         "source": "mmlspark_torch/dl/csrc/flash_attn.cu",
                         "replaces": "mmlspark_tpu/dl/pallas_attention.py:77",
                         "launches": launches,
                         **k2a_at_bert_shape(torch, k2, dev, bw, flush,
                                             padded_rows(biggest, T),
                                             "phase 34", 34)}
    del stage, module, kw
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ compile (35)
COMPILE_ROWS = 500_000        # the SURVEY §7.3 chain's rows (phase 14's)
COMPILE_FEATURES = 30         # float32 feature columns, no strings
COMPILE_NAN = 0.05            # share of NaN cells
COMPILE_SEED = 35
COMPILE_EXAMPLE = 4096        # rows of the example the plan compiles on
COMPILE_RUNS = 5              # compiled and eager transforms, in turn
COMPILE_RTOL = 1e-6           # float columns, compiled against eager
COMPILE_AUC_ATOL = 1e-6
COMPILE_SERVICE = "chain"
# the libraries the store carries: K1, K2a-K2c, K3's window, K3's decode
COMPILE_LIBRARIES = ("mmlspark_hist", "mmlspark_flash", "mmlspark_paged",
                     "mmlspark_paged_decode")
BOOT_PROMPTS = 16             # phase 11's engine: one round of 16 prompts
BOOT_NEW = 16                 # new tokens a prompt
BOOT_GEN = 4                  # prompts through generate (K2c)
BOOT_TIMEOUT = 420            # seconds a booted child may take


def compile_frame(rows: int):
    """500,000 x 30 float32 features with ~5 % NaN and a label from a
    margin of the first four plus noise, made from ``COMPILE_SEED``."""
    rng = np.random.default_rng(COMPILE_SEED)
    x = rng.normal(size=(rows, COMPILE_FEATURES)).astype(np.float32)
    margin = x[:, :4].sum(1) + x[:, 4] * x[:, 5] + rng.normal(size=rows)
    x[rng.random(x.shape) < COMPILE_NAN] = np.nan
    cols = {f"f{i:02d}": x[:, i].copy() for i in range(COMPILE_FEATURES)}
    cols["label"] = (margin > 0).astype(np.float32)
    return cols


def column_digest(df) -> dict:
    """sha256 of each column's dtype, shape and bytes."""
    import hashlib
    out = {}
    for c in df.columns:
        a = np.ascontiguousarray(df[c])
        h = hashlib.sha256(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
        out[c] = h.hexdigest()
    return out


def boot_engine(torch, model, dev, registry):
    """Phase 11's engine shape: 16 slots, block_len 16, paged K3."""
    from mmlspark_torch.serving import LLMEngine
    return LLMEngine(model, slots=16, block_len=16, max_seq_len=18 * 16,
                     num_blocks=1 + 2 * 16 * 18, prefill_batch=4,
                     registry=registry, device=dev)


def boot_prompts():
    vocab = TEXT_SHAPE["vocab"]
    rng = np.random.default_rng(COMPILE_SEED)
    return rng.integers(2, vocab, size=(BOOT_PROMPTS, GEN_T)) \
        .astype(np.int32)


def boot_windows():
    from mmlspark_torch.serving.llm import _bucket_window
    return (_bucket_window(GEN_T), 1)


def jax_engine_names(service="llm", prefill_batch=4, slots=16, spec_k=0):
    """The program names the JAX engine gives this configuration
    (``mmlspark_tpu/serving/llm.py``: ``llm_prefill_<service>_w<w>_b<P>``,
    ``llm_decode_<attn>_<service>_S<S>_k<k>``; both packages' names are
    held equal on the CPU by ``tests/test_torch_aot.py``)."""
    return sorted([f"llm_prefill_{service}_w{w}_b{prefill_batch}"
                   for w in boot_windows()] +
                  [f"llm_decode_paged_{service}_S{slots}_k{spec_k}"])


def serve_round(eng, prompts, t_spawn=None):
    """Submit the round, step until drained. Returns the tokens by
    sequence and the wall-clock time (``time.time()``) when the first
    step, which runs the first prefill and copies its first tokens to the
    host, returned."""
    for i, p in enumerate(prompts):
        eng.submit(f"b{i}", p, BOOT_NEW)
    first = None
    done = {}
    while len(done) < len(prompts):
        for seq_id, toks in eng.step():
            done[seq_id] = [int(t) for t in toks]
        if first is None:
            first = time.time()
    return {k: done[k] for k in sorted(done)}, first


def boot_child(spec_path: str) -> None:
    """A fresh process booting the compile slice's serving path (run by
    phase 35 as ``python3 chip_smoke.py --boot-child <spec.json>``): with
    the spec's AOT store installed (or none), the engine warmed, the saved
    chain compiled and ``warm_aot``-ed, then a round through the engine;
    in mode "warm" also the 500,000-row transform and ``generate``.
    Prints one JSON report (the seconds from the spawn to each stage's
    end in ``marks``)."""
    with open(spec_path) as f:
        spec = json.load(f)
    nvcc_calls = watch_nvcc()

    import torch
    from mmlspark_torch.core import aot, load_stage
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.dl import generate
    from mmlspark_torch.native.loader import CudaLoader
    from mmlspark_torch.obs import MetricsRegistry, compile_tracker, registry
    import mmlspark_torch.dl.flash_attention as k2
    import mmlspark_torch.dl.paged_attention as k3
    import mmlspark_torch.lightgbm.hist as k1
    from mmlspark_torch.device import resolve_device
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if spec.get("store"):
        aot.install(aot.AotStore(spec["store"]))
    report = {"mode": spec["mode"]}
    marks = {"imports": time.time()}

    model = lm_model(torch, "pallas").to(dev).eval()
    marks["model"] = time.time()
    eng = boot_engine(torch, model, dev, MetricsRegistry())
    report["fps"] = {k: list(v) for k, v in eng.warm(
        prefill_windows=boot_windows(), mark_steady=False).items()}
    marks["engine warm"] = time.time()
    chain = load_stage(spec["model"])
    cols = compile_frame(COMPILE_ROWS)
    df = DataFrame(cols)
    cp = chain.compile(df.take(list(range(COMPILE_EXAMPLE))),
                       service=COMPILE_SERVICE, device=dev)
    report["warmed"] = cp.warm_aot()
    marks["pipeline warm"] = time.time()
    compile_tracker.mark_steady()
    for fn in (k2.flash_causal_cuda, k3.paged_cuda, k3.paged_decode_cuda):
        fn.launches = 0
        if hasattr(fn, "combine_launches"):
            fn.combine_launches = 0
    prompts = boot_prompts()
    report["tokens"], first = serve_round(eng, prompts)
    marks["first token"] = first
    report["first_token_s"] = first - spec["t_spawn"]
    report["marks"] = {k: v - spec["t_spawn"] for k, v in marks.items()}
    report["k3_window"] = k3.paged_cuda.launches
    report["k3_decode"] = k3.paged_decode_cuda.launches
    report["k3_combine"] = k3.paged_decode_cuda.combine_launches + \
        k3.paged_cuda.combine_launches
    if spec["mode"] == "warm":
        t = time.perf_counter()
        out = cp.transform(df)
        torch.cuda.synchronize()
        report["transform_s"] = time.perf_counter() - t
        report["digest"] = column_digest(out)
        out = generate(model, prompts[:BOOT_GEN], max_new_tokens=8)
        report["gen_tokens"] = out.tolist()
        report["k2c"] = k2.flash_causal_cuda.launches
        k1.build_kernel()              # K1's library from the store too
    store = aot.active_store()
    report["store"] = store.root if store is not None else None
    report["runtime_compiles"] = compile_tracker.runtime_compiles()
    report["runtime_compiled"] = compile_tracker.runtime_compiled()
    compile_tracker.unmark_steady()
    snap = registry.snapshot()
    report["hits"] = {k: v for k, v in snap.items()
                      if k.startswith("aot_store_hit_total")}
    report["misses"] = {k: v for k, v in snap.items()
                        if k.startswith("aot_store_miss_total")}
    report["backfills"] = sum(v for k, v in snap.items()
                              if k.startswith("aot_store_backfill_total"))
    report["nvcc_calls"] = nvcc_calls
    report["nvcc_runs"] = CudaLoader.nvcc_runs
    report["loaded"] = sorted(CudaLoader._loaded)
    print(json.dumps(report))


def run_boot_child(spec: dict, tmp: str) -> dict:
    """Run ``boot_child`` in a fresh ``python3``; returns its report."""
    path = os.path.join(tmp, f"spec-{spec['mode']}.json")
    env = dict(os.environ)
    env["MMLSPARK_TORCH_BUILD_DIR"] = spec["build_dir"]
    # the store's switch points inside this phase's own directory: at the
    # spec's store, or (cold) at a path that does not exist, so warm_aot
    # can auto-install no store left on the machine by another run
    env["MMLSPARK_TPU_AOT_STORE"] = spec["store"] or os.path.join(
        tmp, f"no-store-{spec['mode']}")
    spec["t_spawn"] = time.time()
    with open(path, "w") as f:
        json.dump(spec, f)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--boot-child", path],
        capture_output=True, text=True, env=env, timeout=BOOT_TIMEOUT)
    if proc.returncode != 0:
        fail(f"phase 35: the {spec['mode']} child exited "
             f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
             f"{proc.stderr[-6000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def miss_reasons(report) -> dict:
    out = {}
    for k, v in report["misses"].items():
        reason = k.split('reason="')[1].split('"')[0]
        out[reason] = out.get(reason, 0) + int(v)
    return out


def compile_phase(torch, k1, k2, k3, dev, card) -> dict:
    """Phase 35: the compile slice. (a) The SURVEY §7.3 chain on numeric
    columns, compiled: one fused segment and the GBDT model eagerly,
    compiled against eager, the tracker, no fallback, no synchronisation
    in a traced form; (b) the AOT store with (a)'s bucket and the K1,
    K2a-K2c and K3 libraries, a fresh process served from it (no nvcc,
    no runtime compile, bit-equal) and a corrupted library (one loud
    miss, a rebuild); (c) phase 11's engine booted from the store in that
    process (fingerprints named as the JAX engine's, the same tokens, the
    first token's seconds cold and warm). Returns phase 35's launches."""
    import shutil
    import tempfile

    from mmlspark_torch.core import DataFrame, Pipeline, aot
    from mmlspark_torch.dl import generate
    from mmlspark_torch.featurize import CleanMissingData, Featurize
    from mmlspark_torch.lightgbm import LightGBMClassifier
    from mmlspark_torch.obs import (MetricsRegistry, compile_tracker,
                                    registry)
    from mmlspark_torch.train import ComputeModelStatistics

    # ---- (a) the fused main path
    t0 = time.perf_counter()
    cols = compile_frame(COMPILE_ROWS)
    names = [c for c in cols if c != "label"]
    df = DataFrame(cols)
    nan_share = float(np.mean([np.isnan(cols[c]).mean() for c in names]))
    print(f"phase 35: frame {COMPILE_ROWS:,} rows x {len(names)} float32 "
          f"features ({nan_share:.2%} NaN), made in "
          f"{time.perf_counter() - t0:.2f} s")
    pipe = Pipeline(stages=[
        CleanMissingData(inputCols=names, cleaningMode="Mean"),
        Featurize(inputCols=names, outputCol="features"),
        LightGBMClassifier(numIterations=20, numLeaves=31, maxBin=255,
                           learningRate=0.1)])
    plain_calls, restore = counting_plain(k1)
    try:
        k1.hist_cuda.launches = 0
        t = time.perf_counter()
        chain = pipe.fit(df)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        k1_launches = k1.hist_cuda.launches
    finally:
        restore()
    if k1_launches != 620 or plain_calls[0]:
        fail(f"phase 35: K1 launches in the chain fit {k1_launches}, plain "
             f"histogram calls {plain_calls[0]}: expected 620 and 0")
    print(f"phase 35: chain fit {fit_s:.3f} s (CleanMissingData Mean, "
          f"Featurize, LightGBMClassifier 20 iterations, 31 leaves, 255 "
          f"bins), K1 launches {k1_launches}, plain histogram calls 0")
    example = df.take(list(range(COMPILE_EXAMPLE)))
    t = time.perf_counter()
    cp = chain.compile(example, service=COMPILE_SERVICE)
    compile_s = time.perf_counter() - t
    plan = cp.describe()
    print(f"phase 35: compiled on {COMPILE_EXAMPLE:,} rows in "
          f"{compile_s:.3f} s: {plan}")
    seg_name = f"{COMPILE_SERVICE}:seg0"
    want_plan = [{"kind": "fused", "segment": seg_name,
                  "stages": ["CleanMissingDataModel", "FeaturizeModel"]},
                 {"kind": "eager", "stage": "LightGBMClassificationModel"}]
    if plan != want_plan:
        fail(f"phase 35: plan {plan}, expected {want_plan}")
    seg = cp.plan[0]
    fb_key = f'pipeline_fused_fallback_total{{segment="{seg_name}"}}'
    fb0 = registry.snapshot().get(fb_key, 0)
    fused_t, eager_t = [], []
    for _ in range(COMPILE_RUNS):
        t = time.perf_counter()
        got = cp.transform(df)
        torch.cuda.synchronize()
        fused_t.append(time.perf_counter() - t)
        t = time.perf_counter()
        want = chain.transform(df)
        torch.cuda.synchronize()
        eager_t.append(time.perf_counter() - t)
    if got.columns != want.columns:
        fail(f"phase 35: compiled columns {got.columns}, eager "
             f"{want.columns}")
    worst = 0.0
    for c in got.columns:
        a, b = np.asarray(got[c]), np.asarray(want[c])
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"phase 35: column {c!r} {a.dtype}{a.shape} compiled, "
                 f"{b.dtype}{b.shape} eager")
        if a.dtype.kind == "f":
            fin = np.isfinite(b)
            if not np.array_equal(np.isnan(a), np.isnan(b)) or \
                    not np.array_equal(a[~fin], b[~fin]):
                fail(f"phase 35: column {c!r} non-finite cells differ")
            rel = float(np.max(np.abs(a[fin] - b[fin]) /
                               np.maximum(np.abs(b[fin]), 1e-30),
                               initial=0.0))
            worst = max(worst, rel)
            if rel > COMPILE_RTOL:
                fail(f"phase 35: column {c!r} compiled against eager "
                     f"{rel:.3e} relative (limit {COMPILE_RTOL})")
        elif not np.array_equal(a, b):
            fail(f"phase 35: column {c!r} compiled differs from eager")
    auc = [float(ComputeModelStatistics(labelCol="label").transform(x)
                 ["AUC"][0]) for x in (got, want)]
    if abs(auc[0] - auc[1]) > COMPILE_AUC_ATOL or not 0.75 < auc[1] <= 1:
        fail(f"phase 35: AUC compiled {auc[0]} eager {auc[1]} (within "
             f"{COMPILE_AUC_ATOL}, in (0.75, 1])")
    comp, calls = compile_tracker.compiles(seg_name), \
        compile_tracker.calls(seg_name)
    fb = registry.snapshot().get(fb_key, 0) - fb0
    if (comp, calls, fb) != (1, COMPILE_RUNS, 0):
        fail(f"phase 35: tracker compiles {comp}, calls {calls}, fallbacks "
             f"{fb}: expected 1, {COMPILE_RUNS}, 0")
    print(f"phase 35: {len(got.columns)} columns compiled against eager: "
          f"integers and bookkeeping equal, floats within {worst:.2e} "
          f"relative (limit {COMPILE_RTOL}); AUC {auc[0]:.6f} / "
          f"{auc[1]:.6f}; tracker compiles {comp}, calls {calls}; "
          f"fallbacks {fb}")
    print(f"phase 35: transform of {COMPILE_ROWS:,} rows, median of "
          f"{COMPILE_RUNS} in turn: compiled {np.median(fused_t):.4f} s "
          f"({', '.join(f'{s:.4f}' for s in fused_t)}), eager "
          f"{np.median(eager_t):.4f} s "
          f"({', '.join(f'{s:.4f}' for s in eager_t)}); {card}")
    # the segment's body on device tensors with every synchronisation an
    # error: no traced form may wait on the card
    from mmlspark_torch.core.compile import trace_columns, upload
    d_host, p_host = seg._split(trace_columns(df))
    d_dev, _ = upload(d_host, seg.device)
    p_dev, _ = upload(p_host, seg.device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        body = seg.call_device(d_dev, p_dev)
    except RuntimeError as e:
        fail(f"phase 35: a traced form synchronised: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if tuple(body["features"].shape) != (COMPILE_ROWS, len(names)):
        fail(f"phase 35: the body's features {tuple(body['features'].shape)}")
    print("phase 35: the segment's body ran on device tensors under "
          "torch.cuda.set_sync_debug_mode('error'): no synchronisation")

    # ---- (b) the store, (c) the engine booted from it
    tmp = tempfile.mkdtemp(prefix="mmlspark_torch_phase35_")
    try:
        root = os.path.join(tmp, "store")
        store = aot.AotStore(root)
        t = time.perf_counter()
        records = aot.build_pipeline(cp, df, store)
        libs = aot.build_libraries(store, COMPILE_LIBRARIES,
                                   log=lambda *_: None)
        build_s = time.perf_counter() - t
        if not (len(records) == 1 and records[0]["built"]):
            fail(f"phase 35: build_pipeline records {records}")
        seg_meta = [m for m in store.entries() if m["tier"] == "program"]
        print(f"phase 35: store built in {build_s:.2f} s at a fresh root: "
              f"{store.stats()['tiers']}; segment {seg_name} bucket cost "
              f"{seg_meta[0]['cost']}; libraries "
              + ", ".join(f"{r['library']} {r['bytes']:,} B" for r in libs)
              + f"; versions {aot.runtime_versions()}")
        model_dir = os.path.join(tmp, "chain")
        chain.save(model_dir)

        # the parent's round and generate: the reference the child is
        # held to
        model = lm_model(torch, "pallas").to(dev).eval()
        eng = boot_engine(torch, model, dev, MetricsRegistry())
        fps = eng.warm(prefill_windows=boot_windows(), mark_steady=False)
        if sorted(fps) != jax_engine_names():
            fail(f"phase 35: engine programs {sorted(fps)}, the JAX "
                 f"engine's {jax_engine_names()}")
        prompts = boot_prompts()
        ref_tokens, _ = serve_round(eng, prompts)
        ref_gen = generate(model, prompts[:BOOT_GEN],
                           max_new_tokens=8).tolist()
        # the child serves the saved chain: its GBDT text moves scores by
        # an ulp against the fitted model, so the parent's reference is
        # the same saved chain, compiled and run here
        from mmlspark_torch.core import load_stage
        ref_digest = column_digest(load_stage(model_dir).compile(
            example, service=COMPILE_SERVICE).transform(df))
        del eng, model
        torch.cuda.empty_cache()

        warm = run_boot_child({"mode": "warm", "store": root,
                               "model": model_dir,
                               "build_dir": os.path.join(tmp, "b-warm")},
                              tmp)
        fps_json = {k: list(v) for k, v in fps.items()}
        misses = miss_reasons(warm)
        problems = []
        if warm["nvcc_calls"] or warm["nvcc_runs"]:
            problems.append(f"nvcc ran: {warm['nvcc_calls']}")
        if warm["runtime_compiles"]:
            problems.append(f"runtime compiles {warm['runtime_compiled']}")
        if not warm["hits"] or misses:
            problems.append(f"hits {warm['hits']}, misses {misses}")
        if warm["warmed"] != 1:
            problems.append(f"warmed {warm['warmed']} buckets")
        if warm["digest"] != ref_digest:
            problems.append("the transform differs from the parent's: "
                            + str([c for c in ref_digest
                                   if warm["digest"].get(c)
                                   != ref_digest[c]]))
        if warm["fps"] != fps_json:
            problems.append(f"fingerprints {warm['fps']} != {fps_json}")
        if warm["tokens"] != ref_tokens or warm["gen_tokens"] != ref_gen:
            problems.append("tokens differ from the parent's round")
        if not set(COMPILE_LIBRARIES) <= set(warm["loaded"]):
            problems.append(f"libraries loaded {warm['loaded']}")
        if not (warm["k2c"] and warm["k3_window"] and warm["k3_decode"]):
            problems.append(f"launches K2c {warm['k2c']}, K3 window "
                            f"{warm['k3_window']}, decode "
                            f"{warm['k3_decode']}")
        if problems:
            fail("phase 35: the process booted from the store: "
                 + "; ".join(problems))
        lib_hits = sorted(k.split('segment="lib:')[1].split('"')[0]
                          for k in warm["hits"] if 'tier="library"' in k)
        print(f"phase 35: a fresh python3 with an empty build directory "
              f"and the store: nvcc 0, runtime compiles 0, store hits "
              f"{int(sum(warm['hits'].values()))} ({len(lib_hits)} "
              f"libraries: {', '.join(lib_hits)}; {warm['warmed']} "
              f"bucket), misses 0; the 500,000-row transform "
              f"({warm['transform_s']:.3f} s) bit-equal to the parent's; "
              f"{len(fps)} engine programs named as the JAX engine's, "
              f"fingerprints equal to the parent's; {BOOT_PROMPTS} prompts "
              f"x {BOOT_NEW} tokens and generate's {BOOT_GEN} x 8 equal "
              f"to the parent's; launches K2c {warm['k2c']}, K3 window "
              f"{warm['k3_window']}, K3 decode {warm['k3_decode']}")

        cold = run_boot_child({"mode": "cold", "store": None,
                               "model": model_dir,
                               "build_dir": os.path.join(tmp, "b-cold")},
                              tmp)
        if cold["tokens"] != ref_tokens or not cold["nvcc_runs"] or \
                cold["store"] is not None or cold["warmed"] or cold["hits"]:
            fail(f"phase 35: the cold child: nvcc runs {cold['nvcc_runs']},"
                 f" tokens equal {cold['tokens'] == ref_tokens}, store "
                 f"{cold['store']}, warmed {cold['warmed']}, hits "
                 f"{cold['hits']}: expected a build, no store, no hit")
        for rep in (cold, warm):
            print(f"phase 35: {rep['mode']} boot, seconds from the spawn: "
                  + ", ".join(f"{k} {v:.2f}"
                              for k, v in rep["marks"].items()))
        SERVED["first_token_s"] = warm["first_token_s"]   # phase 38's
        print(f"phase 35: process start to the first token: cold (no "
              f"store, empty build directory, {cold['nvcc_runs']} nvcc "
              f"builds) {cold['first_token_s']:.2f} s, warm (store) "
              f"{warm['first_token_s']:.2f} s; {card}")

        # a flipped byte in K3 decode's stored library: one loud miss, a
        # rebuild with nvcc, a backfill, the same tokens
        lib = [m for m in store.entries()
               if m.get("library") == "mmlspark_paged_decode"][0]
        path = os.path.join(lib["_dir"], "lib.so")
        blob = bytearray(open(path, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(blob))
        bad = run_boot_child({"mode": "corrupt", "store": root,
                              "model": model_dir,
                              "build_dir": os.path.join(tmp, "b-bad")},
                             tmp)
        reasons = miss_reasons(bad)
        if reasons != {"corrupt": 1} or bad["nvcc_runs"] != 1 or \
                bad["backfills"] != 1 or bad["tokens"] != ref_tokens:
            fail(f"phase 35: corrupted library: misses {reasons}, nvcc "
                 f"runs {bad['nvcc_runs']}, backfills {bad['backfills']}, "
                 f"tokens equal {bad['tokens'] == ref_tokens}: expected "
                 "one corrupt miss, one rebuild, one backfill")
        blob2 = open(path, "rb").read()
        print(f"phase 35: one byte of K3 decode's stored library flipped: "
              f"one loud miss {reasons}, {bad['nvcc_runs']} nvcc rebuild, "
              f"backfilled ({'new bytes' if blob2 != bytes(blob) else 'same'}"
              f"), the same tokens; first token "
              f"{bad['first_token_s']:.2f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"hist": k1_launches, "flash_causal": warm["k2c"],
            "paged_attention_window": warm["k3_window"],
            "paged_attention": warm["k3_decode"],
            "paged_attention_combine": warm["k3_combine"]}


TUNE_REPS = 20                # timed launches a candidate (best of)
TUNE_PAIRS = 16               # winner/default turns, alternating
TUNE_SEED = 36
TUNE_DECODE = dict(S=32, w=1, BL=16, MB=256, H=8, hd=64)  # phase 9's row
TUNE_ENGINE_SEQ = TUNE_DECODE["BL"] * TUNE_DECODE["MB"]   # the same table
TUNE_ENGINE_SLOTS = 16        # the tuned child's engine
TUNE_TIMEOUT = 300            # seconds the tuned child may take
TUNE_AUC_ATOL = 1e-3          # the tuned fit's AUC against the untuned one


def tuned_keys(rows: int) -> dict:
    """The registry keys phase 36 tunes, by record: K1 at phase 3's fit,
    K2a at BERT-base's attention, K2c at the generate prefill and K3's
    decode kernel at phase 9's decode row."""
    from mmlspark_torch.perf import autotune
    d = TUNE_DECODE
    return {"hist": ("hist", autotune.hist_key(rows, 28, 256)),
            "flash_bert": ("flash_attention", autotune.attn_key(
                BERT_BASE["max_len"], 64, False)),
            "flash_causal": ("flash_attention", autotune.attn_key(
                GEN_T - 1, 64, True)),
            "paged_attention": ("paged_attn", autotune.paged_key(
                d["BL"] * d["MB"], d["hd"], d["w"]))}


def report_search(name, rec) -> dict:
    """Print every candidate's time of one search; fail on a discard or
    no winner. Returns the winner's tiles."""
    for t in rec["trials"]:
        tiles = {k: v for k, v in t.items() if k not in ("ms", "discarded")}
        print(f"phase 36: {name} {tiles}: "
              + (f"{t['ms']:.4f} ms" if t["ms"] is not None
                 else f"DISCARDED ({t['discarded']})"))
    if rec["winner"] is None or rec["valid"] != rec["candidates"]:
        fail(f"phase 36: {name}: {rec['valid']} of {rec['candidates']} "
             "candidates timed; every candidate was held against its plain "
             "version first, so a discard is a fault of the kernel")
    return {k: v for k, v in rec["winner"].items() if k != "ms"}


def fwd_tiles(cfg) -> dict:
    """The forward wrappers' tile arguments of one candidate (its q tile
    is the CTA's 128 rows, no argument)."""
    if cfg["block_q"] != 128:
        fail(f"phase 36: a forward candidate with block_q {cfg['block_q']}")
    return {"block_k": cfg["block_k"], "stages": cfg["stages"]}


def decode_tiles(cfg) -> dict:
    """The decode wrapper's tile arguments of one candidate: the chunk its
    grid target gives at the slot count tuned, and its stage."""
    return {"chunk": cfg["chunk"], "stage_positions": cfg["stage_positions"]}


def alternating(autotune, default, winner) -> tuple:
    """Median device ms of ``default`` and ``winner`` over TUNE_PAIRS turns
    taken in alternating order (default first, then winner first, ...),
    each turn the median of 5 launches timed as the tuner times them
    (``autotune.device_times``: L2 flushed, the host's launch work outside
    the events): both read under the same clocks and neighbours."""
    times = {0: [], 1: []}
    for i in range(TUNE_PAIRS):
        for j in ((0, 1) if i % 2 == 0 else (1, 0)):
            times[j].append(float(np.median(autotune.device_times(
                (default, winner)[j], 5))))
    return float(np.median(times[0])), float(np.median(times[1]))


def tune_phase(torch, k1, k2, k3, dev, args) -> dict:
    """Phase 36: the kernels' tile search on the card. Every candidate of
    K1, K2a (BERT-base), K2c (the generate prefill) and K3's decode kernel
    is held against its plain version, then ``perf.autotune`` times them
    all and persists the winners into the run's registry; each winner is
    timed against the default tiles in alternating turns; a fresh process
    that loads the registry at import then runs a BERT-base transform, a
    GBDT fit, a 16-slot engine round and ``generate`` tuned and untuned.
    Returns the ``tuned`` entries of the kernels line, by record."""
    from mmlspark_torch.perf import autotune
    path = autotune.registry_path()
    if os.path.exists(path):
        fail(f"phase 36: a registry exists at {path} before the search")
    gen = torch.Generator(device=dev).manual_seed(TUNE_SEED)
    keys = tuned_keys(args.rows)
    entries = {}

    # K1 at phase 3's fit
    n, F, B = args.rows, 28, 256
    bins = torch.randint(0, B, (n, F), generator=gen, device=dev,
                         dtype=torch.uint8)
    vals = torch.randn(n, 3, generator=gen, device=dev)
    vals[:, 2] = 1.0
    cands = autotune.hist_candidates(n, F, B)
    for c in cands:
        check_hist(torch, k1, f"phase 36 {c}", bins, vals, B, tiles=c)
    rec = autotune.tune_hist(n, F, B, reps=TUNE_REPS, seed=TUNE_SEED)
    best = report_search(f"K1 [{n}, {F}] B={B}", rec)
    d_ms, w_ms = alternating(
        autotune, lambda: k1.hist_cuda(bins, vals, num_bins=B, **cands[0]),
        lambda: k1.hist_cuda(bins, vals, num_bins=B, **best))
    entries["hist"] = (best, w_ms, cands[0], d_ms)
    del bins, vals

    # K2a at BERT-base's attention (the key mask of ragged rows, one fully
    # masked) and K2c at the generate prefill
    H, D, T = BERT_BASE["heads"], 64, BERT_BASE["max_len"]
    Bq = args.docs
    q, k, v = (torch.randn(Bq, H, T, D, generator=gen, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    lens = torch.randint(64, T + 1, (Bq,), generator=gen, device=dev)
    lens[-1] = 0
    mask = torch.arange(T, device=dev)[None, :] < lens[:, None]
    cands = autotune.attention_candidates(T, D)
    # the winner serves every forward instance at its key: K2a and K2b
    for c in cands:
        check_flash(torch, k2, f"phase 36 BERT-base {c}", q, k, v, mask,
                    FLASH_BF16_RTOL, FLASH_BF16_ATOL, tiles=fwd_tiles(c))
        err = check_lse_forward(torch, k2, f"phase 36 BERT-base {c}", q, k,
                                v, mask, tiles=fwd_tiles(c))[-1]
        print(f"K2b phase 36 BERT-base {c}: max |diff| o/lse {err:.3g}")
    # timed on the same ragged rows, the traffic the tiles serve
    rec = autotune.tune_attention(T, D, batch=Bq, heads=H, reps=TUNE_REPS,
                                  seed=TUNE_SEED,
                                  key_lengths=lens.tolist())
    best = report_search(f"K2a [{Bq}, {H}, {T}, {D}]", rec)
    tiles, dflt = fwd_tiles(best), fwd_tiles(cands[0])
    d_ms, w_ms = alternating(
        autotune, lambda: k2.flash_cuda(q, k, v, mask, **dflt),
        lambda: k2.flash_cuda(q, k, v, mask, **tiles))
    entries["flash_bert"] = (best, w_ms, cands[0], d_ms)
    Tp, Hc = GEN_T - 1, TEXT_SHAPE["heads"]
    q, k, v = (torch.randn(GEN_BATCH, Hc, Tp, D, generator=gen, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    cands = autotune.attention_candidates(Tp, D, causal=True)
    # K2c and K2c-lse, which causal training runs at this key
    for c in cands:
        check_causal(torch, k2, f"phase 36 prefill {c}", q, k, v, None,
                     tiles=fwd_tiles(c))
        err = check_lse_forward(torch, k2, f"phase 36 prefill {c}", q, k, v,
                                None, q_off=0, tiles=fwd_tiles(c))[-1]
        print(f"K2c-lse phase 36 prefill {c}: max |diff| o/lse {err:.3g}")
    rec = autotune.tune_attention(Tp, D, causal=True, batch=GEN_BATCH,
                                  heads=Hc, reps=TUNE_REPS, seed=TUNE_SEED)
    best = report_search(f"K2c [{GEN_BATCH}, {Hc}, {Tp}, {D}]", rec)
    tiles, dflt = fwd_tiles(best), fwd_tiles(cands[0])
    d_ms, w_ms = alternating(
        autotune, lambda: k2.flash_causal_cuda(q, k, v, **dflt),
        lambda: k2.flash_causal_cuda(q, k, v, **tiles))
    entries["flash_causal"] = (best, w_ms, cands[0], d_ms)
    del q, k, v, mask

    # K3's decode kernel at phase 9's decode row
    d = TUNE_DECODE
    c = paged_case(torch, dev, TUNE_SEED, d["S"], d["w"], d["BL"], d["MB"],
                   d["H"], d["hd"], torch.bfloat16, full=True)
    kargs = (c["q"], c["k_pool"], c["v_pool"], c["rows"], c["pos"])
    want = k3.paged_torch(*kargs)
    act = torch.from_numpy(c["active"]).to(dev)
    cands = autotune.paged_candidates(d["BL"] * d["MB"], d["BL"], d["H"],
                                      d["hd"], w=d["w"], slots=d["S"])
    for cfg in cands:
        got = k3.paged_decode_cuda(*kargs, **decode_tiles(cfg))
        err = hold(torch, f"K3 decode phase 36 {cfg}", got[act], want[act],
                   PAGED_BF16_RTOL, PAGED_BF16_ATOL)
        if not (got[~act] == 0).all():
            fail(f"phase 36: K3 decode {cfg}: an all-trash slot is not 0")
        print(f"K3 decode phase 36 {cfg}: max |diff| {err:.3g}")
    rec = autotune.tune_paged_attention(
        d["BL"] * d["MB"], d["BL"], d["H"], d["hd"], w=d["w"], slots=d["S"],
        reps=TUNE_REPS, seed=TUNE_SEED)
    best = report_search(f"K3 decode S={d['S']} context "
                         f"{d['BL'] * d['MB']}", rec)
    d_ms, w_ms = alternating(
        autotune, lambda: k3.paged_decode_cuda(*kargs, **decode_tiles(
            cands[0])),
        lambda: k3.paged_decode_cuda(*kargs, **decode_tiles(best)))
    entries["paged_attention"] = (best, w_ms, cands[0], d_ms)
    del c, kargs, want
    # the same key at the tuned child's 16 slots: the winner's grid target
    # cut at 16 slots (the wrapper's own resolution) against the plan's own
    S16 = TUNE_ENGINE_SLOTS
    c = paged_case(torch, dev, TUNE_SEED + 1, S16, d["w"], d["BL"], d["MB"],
                   d["H"], d["hd"], torch.bfloat16, full=True)
    kargs = (c["q"], c["k_pool"], c["v_pool"], c["rows"], c["pos"])
    act = torch.from_numpy(c["active"]).to(dev)
    plan0 = k3.decode_plan(S16, d["H"], d["w"], d["hd"], d["BL"], d["MB"], 2,
                           k3._sm_count(c["q"].device.index))
    tuned16 = k3.plan_of(c["q"], c["k_pool"], c["rows"])
    err = hold(torch, f"K3 decode phase 36 S={S16} {tuned16}",
               k3.paged_decode_cuda(*kargs)[act],
               k3.paged_torch(*kargs)[act], PAGED_BF16_RTOL, PAGED_BF16_ATOL)
    d16, w16 = alternating(
        autotune, lambda: k3.paged_decode_cuda(
            *kargs, chunk=plan0.L, stage_positions=plan0.P),
        lambda: k3.paged_decode_cuda(*kargs))
    print(f"phase 36: K3 decode at {S16} slots: the winner's target cuts "
          f"chunks of {tuned16.L} ({tuned16.ctas} CTAs), {w16:.4f} ms, "
          f"against the plan's {plan0.L} ({plan0.ctas} CTAs), {d16:.4f} ms "
          f"(alternating turns; ratio {w16 / d16:.4f}); max |diff| "
          f"{err:.3g}")
    at16 = {"slots": S16, "chunk": tuned16.L, "ms": w16,
            "default_chunk": plan0.L, "default_ms": d16}
    del c, kargs

    out = {}
    for name, (best, w_ms, dflt, d_ms) in entries.items():
        kernel, key = keys[name]
        print(f"phase 36: {name} {key}: winner {best} {w_ms:.4f} ms, "
              f"default {dflt} {d_ms:.4f} ms (medians of {TUNE_PAIRS} "
              f"alternating turns, each the median of 5 launches, L2 "
              f"flushed; ratio {w_ms / d_ms:.4f})")
        out[name] = {"key": key, "tiles": best, "ms": w_ms,
                     "default": dflt, "default_ms": d_ms}
    out["paged_attention"]["engine_slots"] = at16
    if autotune.load(path) != len(set(keys.values())):
        fail(f"phase 36: the registry at {path} holds "
             f"{len(autotune._WINNERS)} winners, not {len(keys)}")

    # a fresh process: the registry loads at import; tuned, then untuned
    spec = {"rows": args.rows, "iterations": args.iterations,
            "docs": args.docs, "keys": {n_: list(kk)
                                        for n_, kk in keys.items()}}
    spec_path = path + ".child.json"
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--tune-child",
         spec_path], capture_output=True, text=True, timeout=TUNE_TIMEOUT)
    print(proc.stdout.rstrip())
    if proc.returncode != 0:
        fail(f"phase 36: the tuned child exited {proc.returncode}:\n"
             f"{proc.stderr[-6000:]}")
    print(f"phase 36: the tuned child took {time.perf_counter() - t0:.1f} s")
    return out


def tune_child(spec_path: str) -> None:
    """Phase 36's fresh process (``python3 chip_smoke.py --tune-child
    <spec>``): the port loads the run's registry at import; a BERT-base
    transform, a GBDT fit at phase 3's shape, a 16-slot engine round over a
    4,096-position table and ``generate`` run first tuned, then with the
    table cleared. Each tuned key the path reaches must be hit (and none
    untuned), the launch counts equal, the pooled rows within phase 24's
    limits, the AUCs within 1e-3 and every token within phase 11's
    re-score limit. Fails on any of them; prints a summary."""
    with open(spec_path) as f:
        spec = json.load(f)
    import torch
    from mmlspark_torch.perf import autotune
    loaded = dict(autotune._WINNERS)
    import mmlspark_torch.dl.flash_attention as k2
    import mmlspark_torch.dl.paged_attention as k3
    import mmlspark_torch.lightgbm.hist as k1
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.dl import TextEncoderFeaturizer, generate
    from mmlspark_torch.featurize import WordPieceTokenizerModel
    from mmlspark_torch.lightgbm import LightGBMClassifier
    from mmlspark_torch.models import (LoadedModel, bert_encoder_from_torch,
                                       register_bert_encoder)
    from mmlspark_torch.obs import MetricsRegistry
    from mmlspark_torch.serving import LLMEngine
    from mmlspark_torch.train import ComputeModelStatistics
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    want_keys = {f"{kernel}|{key}|cuda" for kernel, key in
                 spec["keys"].values()}
    if set(loaded) != want_keys:
        fail(f"phase 36 child: loaded {sorted(loaded)} at import, expected "
             f"{sorted(want_keys)}")

    hit_keys = set()
    consult = autotune.kernel_winner

    def recording(kernel, shape_key, platform):
        w = consult(kernel, shape_key, platform)
        if w is not None:
            hit_keys.add(f"{kernel}|{shape_key}|{platform}")
        return w
    autotune.kernel_winner = recording

    texts, lengths = make_documents(spec["docs"])
    T = BERT_BASE["max_len"]
    docs = np.asarray([" ".join(t.split()[:n // 5])
                       for t, n in zip(texts, lengths)], object)
    ids = WordPieceTokenizerModel.from_vocab(
        wordpiece_vocab(texts), maxLength=T, inputCol="text").transform(
        DataFrame({"text": docs}))
    schema = register_bert_encoder("BertBase", seq_len=T, **BERT_BASE)
    bert = bert_encoder_from_torch(
        bert_state_dict(torch), config={"num_attention_heads":
                                        BERT_BASE["heads"]},
        dtype=torch.bfloat16)
    stage = TextEncoderFeaturizer(attentionImpl="pallas", seqChunk=128,
                                  model=LoadedModel(schema, bert),
                                  inputCol="tokens")
    feats, labels = higgs_like(spec["rows"])
    df = DataFrame({"features": feats, "label": labels})
    kw = dict(numIterations=spec["iterations"], numLeaves=31, maxBin=255,
              learningRate=0.1)
    lm = lm_model(torch, "pallas").to(dev).eval()
    dense = lm_model(torch, "dense").to(dev).eval()
    prompts = boot_prompts()
    generate(lm, prompts[:BOOT_GEN], max_new_tokens=8)  # the probe, once
    counters = {"K1": k1.hist_cuda, "K2a": k2.flash_cuda,
                "K2c": k2.flash_causal_cuda, "K3 window": k3.paged_cuda,
                "K3 decode": k3.paged_decode_cuda}

    runs = {}
    for mode in ("tuned", "untuned"):
        if mode == "untuned":
            autotune.clear()
        hit_keys.clear()
        reset(counters)
        k3.paged_decode_cuda.combine_launches = 0
        t0 = time.perf_counter()
        pooled = stage.transform(ids)["features"]
        model = LightGBMClassifier(**kw).fit(df)
        auc = float(ComputeModelStatistics(labelCol="label").transform(
            model.transform(df))["AUC"][0])
        eng = LLMEngine(lm, slots=TUNE_ENGINE_SLOTS,
                        block_len=TUNE_DECODE["BL"],
                        max_seq_len=TUNE_ENGINE_SEQ,
                        num_blocks=1 + TUNE_ENGINE_SLOTS * TUNE_DECODE["MB"],
                        prefill_batch=4, registry=MetricsRegistry(),
                        device=dev)
        for i, p_ in enumerate(prompts):
            eng.submit(i, p_, BOOT_NEW)
        out = eng.run_until_drained()
        seqs = np.stack([out[i] for i in range(len(prompts))])
        gen_out = generate(lm, prompts[:BOOT_GEN], max_new_tokens=8)
        torch.cuda.synchronize()
        launches = {**counts(counters),
                    "K3 combine": k3.paged_decode_cuda.combine_launches}
        runs[mode] = dict(pooled=pooled, auc=auc, seqs=seqs, gen=gen_out,
                          launches=launches, hits=set(hit_keys),
                          seconds=time.perf_counter() - t0)
        del eng
        print(f"phase 36 child: {mode}: {runs[mode]['seconds']:.2f} s, "
              f"launches {launches}, AUC {auc:.6f}, winners hit "
              f"{sorted(hit_keys)}")
        # the cut the engine's decode launches ran: the winner's grid
        # target at 16 slots, or the plan's own
        plan = k3.decode_tiles(
            TUNE_ENGINE_SLOTS, TEXT_SHAPE["heads"], 1,
            TEXT_SHAPE["width"] // TEXT_SHAPE["heads"], TUNE_DECODE["BL"],
            TUNE_DECODE["MB"], 2,
            torch.cuda.get_device_properties(0).multi_processor_count)
        print(f"phase 36 child: {mode}: the engine's K3 decode plan {plan}")
        hold_rescore(torch, f"phase 36 child: {mode} engine round", dense,
                     seqs, GEN_T, dev)
        hold_rescore(torch, f"phase 36 child: {mode} generate", dense,
                     gen_out, GEN_T, dev)
    tuned, untuned = runs["tuned"], runs["untuned"]
    if tuned["hits"] != want_keys:
        fail(f"phase 36 child: tuned run hit {sorted(tuned['hits'])}, "
             f"expected every tuned key {sorted(want_keys)}")
    if untuned["hits"]:
        fail(f"phase 36 child: untuned run hit {sorted(untuned['hits'])}")
    if tuned["launches"] != untuned["launches"]:
        fail(f"phase 36 child: launches tuned {tuned['launches']} vs "
             f"untuned {untuned['launches']}")
    cos, ccos, delta = agreement(tuned["pooled"], untuned["pooled"])
    lim = BERT_BF16_POOLED_LIMITS
    print(f"phase 36 child: BERT-base pooled rows, tuned against untuned: "
          f"per-row cosine min {cos:.7f} (floor {lim[0]}), centred "
          f"{ccos:.7f} (floor {lim[1]}), max |diff| {delta:.4g} (limit "
          f"{lim[2]})")
    if cos < lim[0] or ccos < lim[1] or delta > lim[2]:
        fail("phase 36 child: tuned and untuned pooled rows disagree "
             "beyond phase 24's limits")
    if abs(tuned["auc"] - untuned["auc"]) > TUNE_AUC_ATOL:
        fail(f"phase 36 child: AUC tuned {tuned['auc']:.6f} vs untuned "
             f"{untuned['auc']:.6f} (limit {TUNE_AUC_ATOL})")
    same = int(sum(np.array_equal(a, b) for a, b in
                   zip(tuned["seqs"], untuned["seqs"])))
    print(f"phase 36 child: {same} of {len(prompts)} engine sequences and "
          f"{int(np.array_equal(tuned['gen'], untuned['gen']))} generate "
          f"batch identical tuned and untuned; AUC {tuned['auc']:.6f} vs "
          f"{untuned['auc']:.6f}; launches equal {tuned['launches']}")


# ------------------------------------------------------------ serving (37)
SERVING_CONC = 16             # AsyncClient concurrency, loadgen connections
SERVING_CHAIN_ROWS = 256      # distinct chain rows held against the transform
SERVING_BERT_REQUESTS = 64    # distinct BERT-base requests (phase 34's)
SERVING_WARMUP = 20           # loadgen's warm-up requests a connection
SERVING_LOAD_S = 3.0          # seconds a loadgen run must last at least
SERVING_PROBE = 20            # requests a connection in the sizing probe
SERVING_MAX_NREQ = 20_000     # requests a connection, at most
SERVING_FRONTS = ("python", "native")     # named: phase 37 never uses auto


def chain_request(names):
    """A stage turning each request body (a JSON list of the chain's
    feature values, NaN allowed) into the chain's float32 columns
    ``names``: the served chain's first, host-bound item."""
    from mmlspark_torch.core import Transformer

    class ChainRequest(Transformer):
        def _transform(self, frame):
            v = np.asarray([json.loads(r.entity) for r in frame["request"]],
                           np.float32).reshape(len(frame), len(names))
            for i, c in enumerate(names):
                frame = frame.with_column(c, np.ascontiguousarray(v[:, i]))
            return frame

    return ChainRequest()


def serving_chain(torch):
    """Phase 35's chain (CleanMissingData Mean → Featurize →
    LightGBMClassifier, 20 iterations) fitted on the card on
    ``compile_frame(COMPILE_ROWS)``. Returns ``(chain, cols, names)``."""
    from mmlspark_torch.core import DataFrame, Pipeline
    from mmlspark_torch.featurize import CleanMissingData, Featurize
    from mmlspark_torch.lightgbm import LightGBMClassifier
    cols = compile_frame(COMPILE_ROWS)
    names = [c for c in cols if c != "label"]
    chain = Pipeline(stages=[
        CleanMissingData(inputCols=names, cleaningMode="Mean"),
        Featurize(inputCols=names, outputCol="features"),
        LightGBMClassifier(numIterations=20, numLeaves=31, maxBin=255,
                           learningRate=0.1)]).fit(DataFrame(cols))
    torch.cuda.synchronize()
    return chain, cols, names


def serving_bert(torch, dev, name):
    """Phase 24's BERT-base (seeded bf16 weights) behind
    ``TextEncoderFeaturizer(attentionImpl="pallas")`` on K2a, its model
    registered as ``name``. Returns ``(stage, module)``."""
    from mmlspark_torch.dl import TextEncoderFeaturizer
    from mmlspark_torch.models import (LoadedModel, bert_encoder_from_torch,
                                       register_bert_encoder)
    schema = register_bert_encoder(name, seq_len=BERT_BASE["max_len"],
                                   **BERT_BASE)
    module = bert_encoder_from_torch(
        bert_state_dict(torch), config={"num_attention_heads":
                                        BERT_BASE["heads"]},
        dtype=torch.bfloat16).to(dev)
    return TextEncoderFeaturizer(attentionImpl="pallas", inputCol="tokens",
                                 seqChunk=128,
                                 model=LoadedModel(schema, module)), module


def executor_share(query, alone, label) -> None:
    """Print the executor's transform times over the served batches (from
    ``query``'s timed ``transform_fn``) beside the same transform run
    alone on a batch of the median served size (``alone(n)``: seconds)."""
    sizes = np.asarray(query.transform_fn.sizes)
    secs = np.asarray(query.transform_fn.seconds)
    n = int(np.median(sizes))
    solo = float(np.median([alone(n) for _ in range(10)]))
    print(f"phase 37: {label}: {len(secs)} executor transforms, mean "
          f"{sizes.mean():.2f} rows, median {np.median(secs) * 1e3:.3f} ms "
          f"(p90 {np.percentile(secs, 90) * 1e3:.3f} ms), "
          f"{secs.sum():.3f} s in all; the same transform alone on {n} "
          f"rows {solo * 1e3:.3f} ms (median of 10)")


def timed_transform(query) -> None:
    """Wrap ``query.transform_fn`` so that it records each batch's size
    and seconds (the executor reads the attribute at every batch)."""
    fn = query.transform_fn

    def timed(df):
        t0 = time.perf_counter()
        out = fn(df)
        timed.seconds.append(time.perf_counter() - t0)
        timed.sizes.append(len(df))
        return out
    timed.seconds, timed.sizes = [], []
    timed.compiled_segments = getattr(fn, "compiled_segments", None)
    query.transform_fn = timed


def serving_load(run_load, host, port, path, payload, label,
                 seconds=SERVING_LOAD_S, phase="phase 37",
                 warmup=SERVING_WARMUP, probe=SERVING_PROBE) -> dict:
    """``run_load`` closed-loop over ``SERVING_CONC`` connections with
    ``warmup`` warm-up requests each, sized from a probe of ``probe``
    requests a connection so that the run lasts at least ``seconds``.
    Fails on any error, shed or non-200 status."""
    r = run_load(host, port, payload, nconn=SERVING_CONC,
                 nreq=warmup + probe, path=path, warmup=warmup)
    rate = r["completed_rps"]
    for _ in range(3):
        nreq = min(warmup + int(np.ceil(
            1.3 * seconds * rate / SERVING_CONC)), SERVING_MAX_NREQ)
        r = run_load(host, port, payload, nconn=SERVING_CONC, nreq=nreq,
                     path=path, warmup=warmup)
        r["seconds"] = SERVING_CONC * nreq / r["completed_rps"]
        r["nreq"] = nreq
        if r["errors"] or r["shed"] or r["transport_errors"]:
            fail(f"{phase}: {label}: loadgen errors {r['errors']} (shed "
                 f"{r['shed']}, rejected {r['rejected']}, transport "
                 f"{r['transport_errors']}): every status must be 200")
        if r["seconds"] >= seconds or nreq == SERVING_MAX_NREQ:
            break
        rate = r["completed_rps"]
    if r["seconds"] < seconds:
        fail(f"{phase}: {label}: the loadgen run lasted {r['seconds']:.2f} "
             f"s (< {seconds})")
    print(f"{phase}: {label}: loadgen {SERVING_CONC} connections x "
          f"{r['nreq']} requests (warm-up {warmup}) over "
          f"{r['seconds']:.2f} s: {r['throughput_rps']:,.1f} rows/s, p50 "
          f"{r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms (loaded p99 "
          f"{r['loaded_p99_ms']:.3f} ms), shed_rate {r['shed_rate']:g}, "
          f"errors {r['errors']}")
    return r


def serving_phase(torch, k1, k2, dev, bw, flush, texts, card,
                  need_record: bool) -> dict:
    """Phase 37: the serving fronts on the card (module docstring, item
    37). Returns K2a's launches over the served BERT-base transforms and,
    when ``need_record``, its record at this path's shape."""
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.io.http import (AsyncClient, HTTPRequestData,
                                        string_to_response)
    from mmlspark_torch.serving.dsl import ServingStream
    from mmlspark_torch.serving.loadgen import run_load
    from mmlspark_torch.serving.native_front import NativeServingServer
    from mmlspark_torch.serving.server import ServingServer, serving_query

    def post(address, path, bodies):
        """Distinct requests through the port's AsyncClient; every reply
        must be a 200. Returns the reply bodies in order."""
        url = f"http://{address[0]}:{address[1]}{path}"
        out = AsyncClient(concurrency=SERVING_CONC, timeout=60.0).send(
            [HTTPRequestData(url=url, method="POST", entity=b,
                             headers={"Content-Type": "application/json"})
             for b in bodies])
        bad = [r.status_code for r in out if r.status_code != 200]
        if bad:
            fail(f"phase 37: {len(bad)} of {len(out)} replies not 200: "
                 f"{sorted(set(bad))}")
        return [r.entity for r in out]

    # ---- the compiled GBDT chain: phase 35's, fitted here; its 620 K1
    # launches come before any server starts
    t0 = time.perf_counter()
    k1.hist_cuda.launches = 0
    chain, cols, names = serving_chain(torch)
    if k1.hist_cuda.launches != 620:
        fail(f"phase 37: the chain fit made {k1.hist_cuda.launches} K1 "
             "launches: expected 620")
    x = np.stack([cols[c][:SERVING_CHAIN_ROWS] for c in names], 1)
    direct = np.asarray(chain.transform(DataFrame(
        {c: x[:, i].copy() for i, c in enumerate(names)}))
        ["probability"])[:, 1]
    print(f"phase 37: chain fitted on {COMPILE_ROWS:,} rows x {len(names)} "
          f"float32 features (phase 35's) with 620 K1 launches in "
          f"{time.perf_counter() - t0:.2f} s")

    bodies = [json.dumps(r.tolist()).encode() for r in x]
    ex = np.empty(SERVING_CONC, object)
    ex_req = np.empty(SERVING_CONC, object)
    ex[:] = [str(i) for i in range(SERVING_CONC)]
    ex_req[:] = [HTTPRequestData(method="POST", entity=b)
                 for b in bodies[:SERVING_CONC]]
    example = DataFrame({"id": ex, "request": ex_req})

    # ---- BERT-base on K2a: phase 34's module and traffic
    t0 = time.perf_counter()
    T = BERT_BASE["max_len"]
    depth = BERT_BASE["depth"]
    tokens = control_traffic(texts)[0]
    stage, module = serving_bert(torch, dev, "BertBaseServing")

    def frame_of(rows):
        col = np.empty(len(rows), object)
        col[:] = rows
        return DataFrame({"tokens": col})

    served = tokens[:SERVING_BERT_REQUESTS]
    want_pooled = np.asarray(stage.transform(frame_of(served))["features"])
    transforms = [0]

    def embed(df):
        """The executor's work: one featurizer transform a batch, its
        pooled rows copied to the host once (the stage's output)."""
        pooled = np.asarray(stage.transform(frame_of(
            [np.asarray(json.loads(r.entity), np.int32)
             for r in df["request"]]))["features"])
        transforms[0] += 1
        replies = np.empty(len(df), object)
        replies[:] = [string_to_response(json.dumps(v.tolist()),
                                         content_type="application/json")
                      for v in pooled]
        return df.with_column("reply", replies)

    bert_bodies = [json.dumps(t.tolist()).encode() for t in served]
    mid = int(np.argmin([abs(len(t) - sum(CONTROL_TOKENS) // 2)
                         for t in tokens]))
    bert_payload = json.dumps(tokens[mid].tolist()).encode()
    print(f"phase 37: BERT-base (bf16, phase 24's seeded weights) and "
          f"{len(tokens)} requests of {min(map(len, tokens))}-"
          f"{max(map(len, tokens))} tokens in "
          f"{time.perf_counter() - t0:.2f} s; loadgen payload "
          f"{len(tokens[mid])} tokens")

    k1.hist_cuda.launches = 0
    k2a_total = 0
    results = {}
    for backend in SERVING_FRONTS:
        cls = NativeServingServer if backend == "native" else ServingServer
        # the compiled chain through the DSL, on this front
        t0 = time.perf_counter()
        stream = ServingStream(cls(f"chain-{backend}", api_path="/chain"))
        stream.transform(chain_request(names))
        for s in chain.getOrDefault("stages"):
            stream.transform(s)
        stream.compile_pipeline(example, service=f"chain-{backend}")
        plan = stream._stages[0].describe()
        q = stream.with_reply(lambda v: float(v[1]),
                              input_col="probability").start()
        run_chain = q.transform_fn
        timed_transform(q)
        try:
            if type(q.server) is not cls:
                fail(f"phase 37: the chain's front is "
                     f"{type(q.server).__name__}, not {cls.__name__}")
            fused = [p for p in plan if p["kind"] == "fused"]
            if len(fused) != 1 or fused[0]["stages"] != [
                    "CleanMissingDataModel", "FeaturizeModel"]:
                fail(f"phase 37: the served chain's plan {plan}")
            got = np.asarray([json.loads(e) for e in post(
                q.server.address, "/chain", bodies)])
            rel = np.abs(got - direct) / np.maximum(np.abs(direct), 1e-30)
            print(f"phase 37: chain on the {backend} front: "
                  f"{len(got)} rows against the direct transform, max "
                  f"|diff| {np.abs(got - direct).max():.3g}, max relative "
                  f"{rel.max():.3g} (limit {COMPILE_RTOL}); plan {plan}")
            if not np.isfinite(got).all() or rel.max() > COMPILE_RTOL:
                fail(f"phase 37: chain replies on the {backend} front "
                     f"differ from the direct transform beyond "
                     f"{COMPILE_RTOL} relative")
            results[("chain", backend)] = serving_load(
                run_load, *q.server.address, "/chain", bodies[0],
                f"chain on the {backend} front")
        finally:
            q.stop()

        def chain_alone(n):
            frame = DataFrame({"id": np.asarray([str(i) for i in range(n)],
                                                object),
                               "request": np.asarray(
                                   [HTTPRequestData(method="POST",
                                                    entity=bodies[0])] * n,
                                   object)})
            t = time.perf_counter()
            run_chain(frame)
            return time.perf_counter() - t
        executor_share(q, chain_alone, f"chain on the {backend} front")
        print(f"phase 37: chain on the {backend} front: "
              f"{time.perf_counter() - t0:.2f} s")

        # BERT-base through serving_query, on this front
        t0 = time.perf_counter()
        k2.flash_cuda.launches = 0
        transforms[0] = 0
        q = serving_query(f"bert-{backend}", embed, backend=backend)
        timed_transform(q)
        try:
            if type(q.server) is not cls:
                fail(f"phase 37: BERT-base's front is "
                     f"{type(q.server).__name__}, not {cls.__name__}")
            got = np.asarray([json.loads(e) for e in post(
                q.server.address, "/", bert_bodies)], np.float32)
            if got.shape != want_pooled.shape:
                fail(f"phase 37: BERT-base replies {got.shape}, direct "
                     f"{want_pooled.shape}")
            cos, ccos, delta = agreement(got, want_pooled)
            lim = BERT_BF16_POOLED_LIMITS
            print(f"phase 37: BERT-base on the {backend} front: {len(got)} "
                  f"replies against the direct transform: per-row cosine "
                  f"min {cos:.7f} (floor {lim[0]}), centred {ccos:.7f} "
                  f"(floor {lim[1]}), max |diff| {delta:.4g} (limit "
                  f"{lim[2]})")
            if cos < lim[0] or ccos < lim[1] or delta > lim[2] or \
                    not np.isfinite(got).all():
                fail(f"phase 37: BERT-base replies on the {backend} front "
                     "differ from the direct transform beyond phase 24's "
                     "limits")
            results[("bert", backend)] = serving_load(
                run_load, *q.server.address, "/", bert_payload,
                f"BERT-base on the {backend} front")
        finally:
            q.stop()
        launches, n_served = k2.flash_cuda.launches, transforms[0]

        def bert_alone(n):
            frame = DataFrame({"id": np.asarray([str(i) for i in range(n)],
                                                object),
                               "request": np.asarray(
                                   [HTTPRequestData(method="POST",
                                                    entity=bert_payload)]
                                   * n, object)})
            t = time.perf_counter()
            embed(frame)
            return time.perf_counter() - t
        executor_share(q, bert_alone, f"BERT-base on the {backend} front")
        print(f"phase 37: BERT-base on the {backend} front: K2a launches "
              f"{launches} over {n_served} executor transforms "
              f"({time.perf_counter() - t0:.2f} s)")
        if not n_served or launches != depth * n_served:
            fail(f"phase 37: {launches} K2a launches over {n_served} "
                 f"transforms on the {backend} front: expected {depth} a "
                 "transform")
        k2a_total += launches
    if k1.hist_cuda.launches:
        fail(f"phase 37: {k1.hist_cuda.launches} K1 launches while serving")
    print(f"phase 37: K1 launches while serving 0; K2a {k2a_total}")
    for (model, backend), r in sorted(results.items()):
        print(f"phase 37: {model:5s} {backend:6s} front: "
              f"{r['throughput_rps']:,.1f} rows/s, p50 {r['p50_ms']:.3f} "
              f"ms, p99 {r['p99_ms']:.3f} ms; {card}")

    out = {"launches": k2a_total}
    if need_record:
        out["record"] = {"name": "flash_serving", "route": "cuda",
                         "source": "mmlspark_torch/dl/csrc/flash_attn.cu",
                         "replaces": "mmlspark_tpu/dl/pallas_attention.py:77",
                         "launches": k2a_total,
                         **k2a_at_bert_shape(torch, k2, dev, bw, flush,
                                             padded_rows(served, T),
                                             "phase 37", 37)}
    SERVED["chain"] = (chain, cols, names)     # phase 38's v1
    del stage, module, chain
    torch.cuda.empty_cache()
    return out


MESH_SERVICE = "mesh-bert"
MESH_CONC = 16                # AsyncClient concurrency, loadgen connections
MESH_REQUESTS = 64            # distinct BERT-base requests (phase 34's)
MESH_EXACT = 8                # requests sent one at a time, held bit-equal
MESH_LOAD_S = 3.0             # seconds a loadgen run must last at least
MESH_WARMUP = 5               # loadgen's warm-up (and probe) a connection
MESH_HEARTBEAT_S = 3.0        # the registry's heartbeat timeout
MESH_LEASE_S = 10.0           # an ingest's lease deadline
MESH_CHILD_TIMEOUT = 240      # seconds the store-booted child may take
MESH_BURSTS = 8               # bursts of requests until the kill fires
MESH_REPAIR_S = 30.0          # seconds the autoscaler has to repair
MESH_COOLDOWN_S = 120.0       # the autoscaler's cooldown (repair ignores it)
MESH_FAULT_WAIT_S = 5.0       # a planted fault's request: answered by then
ROLLOUT_ITERATIONS = 10       # v2: the chain fitted for this many
ROLLOUT_ROWS = 64             # chain rows sent a rollout step
ROLLOUT_GATED = 16            # requests admitted on v1 across the flip
ROLLOUT_RTOL = 1e-6           # a reply against its version's transform
ROLLOUT_SHARE = 0.25          # the canary's share of admissions
ROLLOUT_PROMOTE = 3           # healthy canary windows before the flip
#: phase 37's fitted chain, kept for phase 38 (``(chain, cols, names)``)
SERVED = {}


def watch_nvcc() -> list:
    """Record every nvcc this process starts from here on (the child
    processes of phases 35 and 38). Returns the list it fills."""
    calls = []
    real_popen = subprocess.Popen

    class Watched(real_popen):
        def __init__(self, args, *a, **k):
            argv = args if isinstance(args, (list, tuple)) else [args]
            if argv and os.path.basename(str(argv[0])) == "nvcc":
                calls.append([str(x) for x in argv[:2]])
            super().__init__(args, *a, **k)
    subprocess.Popen = Watched
    return calls


def mesh_embed(stage, worker: str, state: dict):
    """The mesh's transform: each request body a JSON list of WordPiece
    ids, its reply the pooled row as JSON, with headers naming the worker
    that computed it and the request's id (its owning ingest rides in the
    id). ``state`` counts batches, rows and the first reply's time."""
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.io.http import string_to_response

    def embed(df):
        col = np.empty(len(df), object)
        col[:] = [np.asarray(json.loads(r.entity), np.int32)
                  for r in df["request"]]
        pooled = np.asarray(stage.transform(DataFrame({"tokens": col}))
                            ["features"])
        replies = np.empty(len(df), object)
        replies[:] = [string_to_response(json.dumps(v.tolist()),
                                         content_type="application/json")
                      for v in pooled]
        for rep, rid in zip(replies, df["id"]):
            rep.headers["X-Mesh-Worker"] = worker
            rep.headers["X-Mesh-Id"] = str(rid)
        with state["lock"]:
            state["batches"] += 1
            state["rows"] += len(df)
            if state["first"] is None:
                state["first"] = time.time()
        return df.with_column("reply", replies)
    return embed


def mesh_child(spec_path: str) -> None:
    """Phase 38's compute worker (``python3 chip_smoke.py --mesh-child
    <spec.json>``): BERT-base on the card behind ``remote_worker_loop``,
    with an empty kernel build directory and the store's root in
    ``MMLSPARK_TPU_AOT_STORE`` (``maybe_warm`` installs it before the first
    lease), so only the store can supply K2a. Serves until the spec's stop
    file appears; prints its counts on a line, then one JSON report."""
    import threading
    with open(spec_path) as f:
        spec = json.load(f)
    nvcc_calls = watch_nvcc()
    import torch
    import mmlspark_torch.dl.flash_attention as k2
    from mmlspark_torch.device import resolve_device
    from mmlspark_torch.native.loader import CudaLoader
    from mmlspark_torch.obs import compile_tracker, registry
    from mmlspark_torch.serving import remote_worker_loop
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    stage, _ = serving_bert(torch, dev, "BertBaseMeshChild")
    state = {"lock": threading.Lock(), "batches": 0, "rows": 0,
             "first": None}
    embed = mesh_embed(stage, "child", state)
    k2.flash_cuda.launches = 0
    compile_tracker.mark_steady()
    stop = threading.Event()

    def watch():
        while not os.path.exists(spec["stop"]):
            time.sleep(0.05)
        stop.set()
    threading.Thread(target=watch, daemon=True).start()
    remote_worker_loop(spec["driver"], spec["service"], embed,
                       stop_event=stop, max_batch=MESH_CONC,
                       worker_id="mesh-child")
    snap = registry.snapshot()
    report = {
        "batches": state["batches"], "rows": state["rows"],
        "first_reply_s": (state["first"] - spec["t_spawn"]
                          if state["first"] else None),
        "k2a": k2.flash_cuda.launches,
        "nvcc_calls": nvcc_calls, "nvcc_runs": CudaLoader.nvcc_runs,
        "runtime_compiles": compile_tracker.runtime_compiles(),
        "hits": {k: v for k, v in snap.items()
                 if k.startswith("aot_store_hit_total")},
        "misses": {k: v for k, v in snap.items()
                   if k.startswith("aot_store_miss_total")},
        "loaded": sorted(CudaLoader._loaded)}
    print(f"phase 38 child: {report['batches']} batches, {report['rows']} "
          f"rows, K2a launches {report['k2a']}, nvcc {report['nvcc_runs']}, "
          f"runtime compiles {report['runtime_compiles']}, store hits "
          f"{int(sum(report['hits'].values()))}, misses "
          f"{int(sum(report['misses'].values()))}", flush=True)
    print(json.dumps(report), flush=True)


def http_json(address, path, payload=None):
    """POST ``payload`` as JSON (or GET when None) to ``path`` on
    ``address``; returns (status, parsed body or None)."""
    import http.client
    conn = http.client.HTTPConnection(*address, timeout=30)
    try:
        if payload is None:
            conn.request("GET", path)
        else:
            conn.request("POST", path, body=json.dumps(payload).encode(),
                         headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = resp.read()
        try:
            return resp.status, json.loads(body or b"null")
        except ValueError:
            return resp.status, None
    finally:
        conn.close()


def header(reply, name: str) -> str:
    for k, v in (reply.headers or {}).items():
        if k.lower() == name.lower():
            return v
    return ""


def owner_problems(sent: dict, via: dict) -> list:
    """The reply-routing check: ``sent`` maps each ingest's worker id to
    the request ids answered to clients of that ingest; ``via`` maps each
    ingest to the ids whose replies were posted to its ``__reply__``. A
    request's owner (the id's prefix) must be the ingest that received
    it, and its reply must have been posted there and nowhere else."""
    out = []
    for ingest, ids in sent.items():
        for rid in ids:
            if rid.split("/", 1)[0] != ingest:
                out.append(f"{rid} received by {ingest}, owned by "
                           f"{rid.split('/', 1)[0]}")
            if rid not in via.get(ingest, ()):
                out.append(f"{rid}'s reply did not come back through "
                           f"{ingest}")
    for ingest, ids in via.items():
        for rid in ids:
            if rid.split("/", 1)[0] != ingest:
                out.append(f"a reply for {rid} was posted to {ingest}")
    return out


def rollout_problems(replies, direct: dict) -> list:
    """Every reply a 200 stamped ``X-Model-Version`` with the version the
    router assigned its request at admission, and its probability within
    ``ROLLOUT_RTOL`` relative of that version's direct transform of the
    same row: a request admitted on v1 completes on v1 whenever the flip
    lands. ``replies`` holds (row, response, admitted version) triples."""
    out = []
    for row, r, admitted in replies:
        ver = header(r, "X-Model-Version")
        if r.status_code != 200 or admitted not in direct:
            out.append(f"row {row}: status {r.status_code}, admitted on "
                       f"{admitted!r}")
            continue
        if ver != admitted:
            out.append(f"row {row}: admitted on {admitted}, stamped "
                       f"{ver!r}")
            continue
        got, want = json.loads(r.entity)["p"], direct[admitted][row]
        if not abs(got - want) <= ROLLOUT_RTOL * max(abs(want), 1e-30):
            out.append(f"row {row}: {got} on {ver}, whose transform gives "
                       f"{want}")
    return out


def mesh_phase(torch, k1, k2, dev, texts, card) -> dict:
    """Phase 38: the serving mesh, the autoscaler and the deploy plane on
    the card (module docstring, item 38). Returns K2a's launches in the
    mesh (the child's and this process's)."""
    import shutil
    import tempfile
    import threading

    from mmlspark_torch.core import DataFrame, Pipeline, aot
    from mmlspark_torch.featurize import CleanMissingData, Featurize
    from mmlspark_torch.io.http import (AsyncClient, HTTPRequestData,
                                        HTTPResponseData)
    from mmlspark_torch.lightgbm import LightGBMClassifier
    from mmlspark_torch.obs import registry
    from mmlspark_torch.resilience import FaultRule, injector
    from mmlspark_torch.serving import (Autoscaler, AutoscaleConfig,
                                        AutoscaleSignals, ComputeWorkerPool,
                                        DistributedServingServer,
                                        DriverRegistry, ModelRegistry,
                                        NativeDistributedServingServer,
                                        RolloutConfig, RolloutController,
                                        VersionRouter, serving_query)
    from mmlspark_torch.serving.deploy import RETIRED
    from mmlspark_torch.serving.loadgen import run_load

    def send(address, bodies, conc=MESH_CONC, timeout=120.0, path="/"):
        url = f"http://{address[0]}:{address[1]}{path}"
        return AsyncClient(concurrency=conc, timeout=timeout).send(
            [HTTPRequestData(url=url, method="POST", entity=b,
                             headers={"Content-Type": "application/json"})
             for b in bodies])

    def counter(prefix, label=""):
        return sum(v for k, v in registry.snapshot().items()
                   if k.startswith(prefix) and label in k)

    tmp = tempfile.mkdtemp(prefix="mmlspark_torch_phase38_")
    child = driver = None
    ingests, logs, stops = {}, {}, []
    try:
        # ---- the store: K2a's library at a fresh root (phase 35's way)
        t0 = time.perf_counter()
        root = os.path.join(tmp, "store")
        libs = aot.build_libraries(aot.AotStore(root), ("mmlspark_flash",),
                                   log=lambda *_: None)
        print("phase 38: store at a fresh root with "
              + ", ".join(f"{r['library']} {r['bytes']:,} B" for r in libs)
              + f" in {time.perf_counter() - t0:.2f} s")

        # ---- the mesh: a registry and two ingest servers, one a front
        driver = DriverRegistry(heartbeat_timeout=MESH_HEARTBEAT_S).start()
        for front, cls in (("python", DistributedServingServer),
                           ("native", NativeDistributedServingServer)):
            ing = cls(MESH_SERVICE, driver.address, worker_id=f"ingest-"
                      f"{front}", lease_timeout=MESH_LEASE_S,
                      reply_timeout=180.0).start()
            if type(ing) is not cls:
                fail(f"phase 38: the {front} ingest is "
                     f"{type(ing).__name__}")
            log = logs[ing.worker_id] = []
            real = ing._routes["/__reply__"]

            def logged(body, real=real, log=log):
                log.append(json.loads(body)["id"])
                return real(body)
            ing._routes["/__reply__"] = logged
            ingests[front] = ing

        # ---- the store-booted compute worker, a fresh python3
        stop_file = os.path.join(tmp, "stop")
        spec = {"driver": "%s:%d" % driver.address, "service": MESH_SERVICE,
                "stop": stop_file, "t_spawn": time.time()}
        spec_path = os.path.join(tmp, "mesh-child.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        env = dict(os.environ)
        env["MMLSPARK_TORCH_BUILD_DIR"] = os.path.join(tmp, "b-child")
        env["MMLSPARK_TPU_AOT_STORE"] = root
        # the child writes to files, never to a pipe nobody drains: a
        # child blocked on a full pipe would stop heartbeating

        def child_log(stream):
            with open(os.path.join(tmp, f"mesh-child.{stream}"),
                      errors="replace") as f:
                return f.read()
        with open(os.path.join(tmp, "mesh-child.out"), "w") as out_f, \
                open(os.path.join(tmp, "mesh-child.err"), "w") as err_f:
            child = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-child",
                 spec_path], env=env, stdout=out_f, stderr=err_f)
        tokens = control_traffic(texts)[0]
        served = tokens[:MESH_REQUESTS]
        bodies = [json.dumps(t.tolist()).encode() for t in served]
        first = {}

        def first_request():
            r = send(ingests["python"].address, bodies[:1], conc=1,
                     timeout=MESH_CHILD_TIMEOUT)[0]
            first["reply"], first["t"] = r, time.time()
        first_thread = threading.Thread(target=first_request, daemon=True)
        first_thread.start()

        # ---- the rollout (while the child boots): v1 phase 37's chain,
        # v2 the same chain fitted for ROLLOUT_ITERATIONS
        t0 = time.perf_counter()
        if "chain" in SERVED:
            chain, cols, names = SERVED.pop("chain")
        else:
            chain, cols, names = serving_chain(torch)
        k1.hist_cuda.launches = 0
        chain2 = Pipeline(stages=[
            CleanMissingData(inputCols=names, cleaningMode="Mean"),
            Featurize(inputCols=names, outputCol="features"),
            LightGBMClassifier(numIterations=ROLLOUT_ITERATIONS, numLeaves=31,
                               maxBin=255, learningRate=0.1)]).fit(
            DataFrame(cols))
        torch.cuda.synchronize()
        fit2 = k1.hist_cuda.launches
        x = np.stack([cols[c][:ROLLOUT_ROWS] for c in names], 1)
        example = DataFrame({c: x[:MESH_CONC, i].copy()
                             for i, c in enumerate(names)})
        frame = DataFrame({c: x[:, i].copy() for i, c in enumerate(names)})
        versions = {"v1": chain.compile(example, service="mesh-v1"),
                    "v2": chain2.compile(example, service="mesh-v2")}
        direct = {v: np.asarray(cp.transform(frame)["probability"])[:, 1]
                  .astype(np.float64) for v, cp in versions.items()}
        print(f"phase 38: v2 fitted ({ROLLOUT_ITERATIONS} iterations, "
              f"{fit2} K1 launches) and both versions compiled in "
              f"{time.perf_counter() - t0:.2f} s")
        row_bodies = [json.dumps({"row": i, "x": r.tolist()}).encode()
                      for i, r in enumerate(x)]

        def version_fn(cp, gate=None, stamp_at_reply=None):
            """A version's transform. ``gate``: an Event the transform
            waits on (holds requests admitted on it across a flip);
            ``stamp_at_reply``: the planted fault, the router's active
            version stamped at reply time."""
            def run(df):
                if gate is not None:
                    gate.wait(60)
                reqs = [json.loads(r.entity) for r in df["request"]]
                v = np.asarray([q["x"] for q in reqs], np.float32)
                p = np.asarray(cp.transform(DataFrame(
                    {c: np.ascontiguousarray(v[:, i])
                     for i, c in enumerate(names)}))["probability"])[:, 1]
                replies = np.empty(len(df), object)
                replies[:] = [HTTPResponseData(
                    status_code=200, entity=json.dumps(
                        {"p": float(pi)}).encode(),
                    headers={"Content-Type": "application/json"})
                    for pi in p]
                if stamp_at_reply is not None:
                    for rep in replies:
                        rep.headers["X-Model-Version"] = \
                            stamp_at_reply.active
                return df.with_column("reply", replies)
            return run

        def rollout(plant=None):
            """Stage v2 as a canary, promote it through the controller
            with ROLLOUT_GATED requests held across the flip. ``plant``:
            None, ``"stamp"`` (the planted fault: the router's active
            version stamped at reply time) or ``"execute"`` (the planted
            fault: the executor picks the version at execute time).
            Returns (row, reply, admitted version) triples, the rows of
            the gated requests admitted on v1 before the flip, the
            controller's decisions and ``/debug/deploy`` before and
            after."""
            mreg = ModelRegistry(service="mesh-rollout")
            router = VersionRouter(mreg, service="mesh-rollout")
            gate = threading.Event()
            stamp = router if plant == "stamp" else None
            mreg.register("v1", transform=version_fn(versions["v1"], gate,
                                                     stamp))
            mreg.register("v2", transform=version_fn(versions["v2"],
                                                     None, stamp))
            router.set_active("v1")
            ctl = RolloutController(router, config=RolloutConfig(
                promote_windows=ROLLOUT_PROMOTE, cooldown=0.0))
            q = serving_query("mesh-rollout", version_fn(versions["v1"]),
                              backend="native", router=router)
            # each request's admitted version, read from the router's own
            # decision: assign() and the scheduler's submit run back to
            # back on the admitting thread
            assigned, admitted = threading.local(), {}
            real_assign, real_submit = router.assign, q.server.scheduler.submit

            def assign(tenant=""):
                ver, override = real_assign(tenant)
                assigned.ver = ver
                return ver, override

            def submit(cached, *a, **k):
                admitted[json.loads(cached.request.entity)["row"]] = \
                    assigned.ver
                return real_submit(cached, *a, **k)
            router.assign, q.server.scheduler.submit = assign, submit
            if plant == "execute":
                def at_execute(batch):
                    ver = router.active
                    return [(ver, router.transform_for(ver), list(batch))]
                q._transform_groups = at_execute

            def step(rows, replies):
                return [(i, r, admitted.get(i)) for i, r in zip(rows, replies)]

            out, decisions = [], []
            try:
                addr = q.server.address
                gate.set()
                rows = range(ROLLOUT_ROWS)
                out += step(rows, send(addr, row_bodies))
                router.stage("v2", canary_share=ROLLOUT_SHARE)
                for _ in range(ROLLOUT_PROMOTE - 1):
                    admitted.clear()
                    out += step(rows, send(addr, row_bodies))
                    decisions.append(ctl.tick(burns={}))
                before = http_json(addr, "/debug/deploy")[1]
                gate.clear()
                admitted.clear()
                held = {}

                def gated():
                    held["r"] = send(addr, row_bodies[:ROLLOUT_GATED])
                th = threading.Thread(target=gated, daemon=True)
                th.start()
                deadline = time.monotonic() + 30
                while len(admitted) < ROLLOUT_GATED and \
                        time.monotonic() < deadline:
                    time.sleep(0.005)
                on_v1 = sorted(i for i, v in admitted.items() if v == "v1")
                decisions.append(ctl.tick(burns={}))       # the flip

                def later():        # all admitted while v1 is held
                    held["after"] = send(addr, row_bodies[ROLLOUT_GATED:],
                                         conc=ROLLOUT_ROWS - ROLLOUT_GATED)
                th2 = threading.Thread(target=later, daemon=True)
                th2.start()
                while len(admitted) < ROLLOUT_ROWS and \
                        time.monotonic() < deadline:
                    time.sleep(0.005)
                gate.set()
                th.join(60)
                th2.join(60)
                out += step(range(ROLLOUT_GATED), held.get("r", []))
                out += step(range(ROLLOUT_GATED, ROLLOUT_ROWS),
                            held.get("after", []))
                deadline = time.monotonic() + 5
                while True:
                    deploy = http_json(addr, "/debug/deploy")[1]
                    if router.draining_inflight() == 0 or \
                            time.monotonic() > deadline:
                        break
                    time.sleep(0.01)
            finally:
                gate.set()
                q.stop()
            return out, on_v1, decisions, before, deploy

        k1.hist_cuda.launches = 0
        t0 = time.perf_counter()
        got, on_v1, decisions, before, deploy = rollout()
        problems = rollout_problems(got, direct)
        vers = [header(r, "X-Model-Version") for _, r, _ in got]
        states = {v["name"]: v["state"] for v in deploy["versions"]}
        if len(got) != ROLLOUT_ROWS * (ROLLOUT_PROMOTE + 1):
            problems.append(f"{len(got)} replies")
        if not on_v1:
            problems.append("no gated request was admitted on v1 before "
                            "the flip")
        held_v1 = [header(r, "X-Model-Version") for i, r, _ in
                   got[-ROLLOUT_ROWS:] if i in on_v1]
        if len(held_v1) != len(on_v1) or set(held_v1) - {"v1"}:
            problems.append(f"the gated requests admitted on v1 came back "
                            f"on {held_v1}")
        if decisions != ["hold"] * (ROLLOUT_PROMOTE - 1) + ["promote"]:
            problems.append(f"controller decisions {decisions}")
        if before["active"] != "v1" or before["candidate"] != "v2" or \
                deploy["active"] != "v2" or deploy["prior"] != "v1" or \
                states.get("v1") != RETIRED:
            problems.append(f"/debug/deploy before the flip {before}, "
                            f"after {deploy}")
        if k1.hist_cuda.launches:
            problems.append(f"{k1.hist_cuda.launches} K1 launches while "
                            "serving")
        if problems:
            fail("phase 38: rollout: " + "; ".join(problems[:8]))
        print(f"phase 38: rollout on the epoll front: v1 active, v2 staged "
              f"as a {ROLLOUT_SHARE:g} canary, promoted by the controller "
              f"after {ROLLOUT_PROMOTE} healthy windows ({decisions}) with "
              f"{ROLLOUT_GATED} requests held across the flip, "
              f"{len(on_v1)} of them admitted on v1 before it and every "
              f"one of those completed on v1; {len(got)} replies, "
              f"{vers.count('v1')} on v1 and {vers.count('v2')} on v2, "
              f"every one stamped X-Model-Version with the version its "
              f"request was admitted on and within {ROLLOUT_RTOL:g} "
              f"relative of that version's transform; /debug/deploy: "
              f"active {deploy['active']}, prior {deploy['prior']}, v1 "
              f"{states['v1']}; K1 launches while serving 0 "
              f"({time.perf_counter() - t0:.2f} s)")
        for plant, what in (("stamp", "the version stamped at reply time"),
                            ("execute", "the executor picks the version at "
                                        "execute time")):
            planted = rollout_problems(rollout(plant)[0], direct)
            if not planted:
                fail(f"phase 38: a planted fault ({what}) passed the "
                     "rollout check")
            print(f"phase 38: planted fault, {what}: {len(planted)} "
                  f"replies caught ({planted[0]})")

        # ---- this process's BERT-base (the direct transforms), then the
        # child's first reply
        stage, module = serving_bert(torch, dev, "BertBaseMeshParent")
        wants = []
        for i in range(MESH_EXACT):
            one = np.empty(1, object)
            one[0] = served[i]
            wants.append(np.asarray(stage.transform(DataFrame(
                {"tokens": one}))["features"])[0])
        col = np.empty(len(served), object)
        col[:] = served
        want_pooled = np.asarray(stage.transform(DataFrame(
            {"tokens": col}))["features"])
        pstate = {"lock": threading.Lock(), "batches": 0, "rows": 0,
                  "first": None}
        # ---- planted fault: replay switched off, expiry never requeues
        # (its own registry and service, run while the child boots)
        def lost_request(replay_on: bool) -> int:
            svc = f"mesh-replay-{'on' if replay_on else 'off'}"
            reg = DriverRegistry(heartbeat_timeout=1.0).start()
            ing = DistributedServingServer(svc, reg.address,
                                           lease_timeout=2.0,
                                           reply_timeout=30.0).start()
            if not replay_on:
                ing.replay = lambda cached: None
            injector.configure(380, [FaultRule(
                "worker.death", "kill", match=f"{svc}-w0", times=1)])
            p = ComputeWorkerPool(reg.address, svc, mesh_embed(
                stage, "pool", pstate), prefix=svc)
            out = {}
            try:
                p.scale_up()
                th = threading.Thread(target=lambda: out.update(r=send(
                    ing.address, bodies[:1], conc=1,
                    timeout=MESH_FAULT_WAIT_S)[0]), daemon=True)
                th.start()
                deadline = time.monotonic() + MESH_FAULT_WAIT_S
                while f"{svc}-w0" in p.worker_ids() and \
                        time.monotonic() < deadline:
                    time.sleep(0.02)
                p.scale_up()                       # the survivor
                th.join(MESH_FAULT_WAIT_S + 5)
            finally:
                injector.clear()
                p.stop()
                ing.stop()
                reg.stop()
            r = out.get("r")
            return r.status_code if r is not None else 0
        on, off = lost_request(True), lost_request(False)
        if on != 200:
            fail(f"phase 38: a killed lessee's request with replay on: "
                 f"{on}")
        if off == 200:
            fail("phase 38: a lease whose replay is switched off was "
                 "answered: the check cannot see a lost lease")
        print(f"phase 38: planted fault, replay switched off: the killed "
              f"lessee's request {off or 'unanswered'} within "
              f"{MESH_FAULT_WAIT_S:g} s (with replay on: {on})")

        first_thread.join(MESH_CHILD_TIMEOUT)
        r = first.get("reply")
        if r is None or r.status_code != 200 or \
                header(r, "X-Mesh-Worker") != "child":
            rc = child.poll()
            fail(f"phase 38: the child's first reply: "
                 f"{getattr(r, 'status_code', None)} from "
                 f"{header(r, 'X-Mesh-Worker') if r else None} (the child "
                 + ("still runs" if rc is None else f"exited {rc}")
                 + f")\n{child_log('err')[-6000:]}")
        first_s = first["t"] - spec["t_spawn"]
        boot = SERVED.get("first_token_s")
        print(f"phase 38: the store-booted child's first reply {first_s:.2f} "
              f"s after its spawn (phase 35's store-booted first token: "
              + (f"{boot:.2f} s" if boot is not None else "phase 35 not run")
              + f"); {card}")

        # ---- replies: bit-equal one at a time, within limits in a crowd
        exact = []
        for i in range(MESH_EXACT):
            rep = send(ingests[("python", "native")[i % 2]].address,
                       bodies[i:i + 1], conc=1)[0]
            got_row = np.asarray(json.loads(rep.entity), np.float32)
            exact.append(rep.status_code == 200
                         and np.array_equal(got_row, wants[i]))
        if not all(exact):
            fail(f"phase 38: {exact.count(False)} of {MESH_EXACT} single "
                 "requests differ from the direct transform of the same "
                 "batch")
        sent = {ing.worker_id: [] for ing in ingests.values()}
        halves = {"python": range(0, MESH_REQUESTS, 2),
                  "native": range(1, MESH_REQUESTS, 2)}
        got_rows = np.zeros_like(want_pooled)
        for front, idx in halves.items():
            reps = send(ingests[front].address, [bodies[i] for i in idx])
            for i, rep in zip(idx, reps):
                if rep.status_code != 200:
                    fail(f"phase 38: request {i} on the {front} ingest: "
                         f"{rep.status_code}")
                got_rows[i] = json.loads(rep.entity)
                sent[ingests[front].worker_id].append(
                    header(rep, "X-Mesh-Id"))
        cos, ccos, delta = agreement(got_rows, want_pooled)
        lim = BERT_BF16_POOLED_LIMITS
        if cos < lim[0] or ccos < lim[1] or delta > lim[2] or \
                not np.isfinite(got_rows).all():
            fail(f"phase 38: mesh replies against the direct transform: "
                 f"cosine {cos}, centred {ccos}, |diff| {delta}")
        ids = set(sum(sent.values(), []))
        via = {k: [i for i in v if i in ids] for k, v in logs.items()}
        problems = owner_problems(sent, via)
        if problems:
            fail("phase 38: reply routing: " + "; ".join(problems[:5]))
        print(f"phase 38: {MESH_EXACT} requests one at a time bit-equal to "
              f"the direct transform of the same row; {MESH_REQUESTS} "
              f"through AsyncClient (concurrency {MESH_CONC}, half a "
              f"front): per-row cosine min {cos:.7f} (floor {lim[0]}), "
              f"centred {ccos:.7f} (floor {lim[1]}), max |diff| {delta:.4g} "
              f"(limit {lim[2]}); every reply posted back to the ingest "
              f"that received and owns its request")
        # planted fault: a reply for the threaded ingest's request posted
        # to the epoll ingest
        rid = sent["ingest-python"][0]
        status, _ = http_json(ingests["native"].address, "/__reply__",
                              {"id": rid, "response": {
                                  "status_code": 200, "reason": "",
                                  "headers": {}, "entity_b64": ""}})
        via_bad = {k: [i for i in v if i in ids] for k, v in logs.items()}
        caught = owner_problems(sent, via_bad)
        if not caught:
            fail("phase 38: a reply posted to the wrong owner passed the "
                 "routing check")
        print(f"phase 38: planted fault, a reply posted to the wrong "
              f"owner: refused ({status}) and caught ({caught[0]})")

        # ---- load through each ingest, the child computing
        mid = int(np.argmin([abs(len(t) - sum(CONTROL_TOKENS) // 2)
                             for t in tokens]))
        payload = json.dumps(tokens[mid].tolist()).encode()
        load = {}
        for front, ing in ingests.items():
            load[front] = serving_load(
                run_load, *ing.address, "/", payload,
                f"BERT-base through the mesh, {front} ingest",
                seconds=MESH_LOAD_S, phase="phase 38", warmup=MESH_WARMUP,
                probe=MESH_WARMUP)

        # ---- a pool worker killed while it holds a lease
        embed = mesh_embed(stage, "pool", pstate)
        injector.configure(38, [FaultRule("worker.death", "kill",
                                          match="mesh-pool-w0", times=1)])
        pool = ComputeWorkerPool(driver.address, MESH_SERVICE, embed,
                                 max_batch=4, prefix="mesh-pool")
        stops.append(pool.stop)
        scaler = Autoscaler(MESH_SERVICE, pool, AutoscaleConfig(
            min_workers=1, max_workers=2, up_stable=1,
            cooldown=MESH_COOLDOWN_S))
        scaler.ensure_min()
        t_up = time.monotonic()
        if scaler.tick(AutoscaleSignals(queue_depth=1e4)) != "up":
            fail("phase 38: the autoscaler did not scale up")
        replays0 = counter("serving_lease_replays_total")
        k2.flash_cuda.launches, batches0 = 0, pstate["batches"]
        ticks = {"died": None, "replace": None}
        done = threading.Event()

        def tick_loop():
            while not done.wait(0.05):
                if ticks["died"] is None and \
                        "mesh-pool-w0" not in pool.worker_ids():
                    ticks["died"] = time.monotonic()
                if ticks["died"] is not None and scaler.tick() == "replace":
                    ticks["replace"] = time.monotonic()
                    return
        ticker = threading.Thread(target=tick_loop, daemon=True)
        ticker.start()
        t0 = time.perf_counter()
        answered = 0
        for burst in range(MESH_BURSTS):
            for front, idx in halves.items():
                reps = send(ingests[front].address,
                            [bodies[i] for i in idx[:16]])
                rows = np.asarray([json.loads(r.entity) if r.status_code
                                   == 200 else np.zeros(want_pooled.shape[1])
                                   for r in reps], np.float32)
                bad = [r.status_code for r in reps if r.status_code != 200]
                c2, cc2, d2 = agreement(rows, want_pooled[list(idx[:16])])
                if bad or c2 < lim[0] or cc2 < lim[1] or d2 > lim[2]:
                    fail(f"phase 38: across the worker's death: statuses "
                         f"{bad}, cosine {c2}, centred {cc2}, |diff| {d2}")
                answered += len(reps)
            if injector.schedule():
                break
        if not injector.schedule():
            fail(f"phase 38: the pool worker never leased in "
                 f"{MESH_BURSTS} bursts: no death to replay")
        deadline = time.monotonic() + MESH_REPAIR_S
        while ticks["replace"] is None and time.monotonic() < deadline:
            time.sleep(0.05)
        done.set()
        ticker.join(5)
        replays = counter("serving_lease_replays_total") - replays0
        parent = k2.flash_cuda.launches
        parent_batches = pstate["batches"] - batches0
        deaths = counter("resilience_worker_deaths_total",
                         f'service="{MESH_SERVICE}#compute"')
        events = scaler.event_log()
        if replays < 1 or ticks["replace"] is None or \
                events[-1].direction != "replace" or \
                ticks["replace"] - t_up >= MESH_COOLDOWN_S or \
                pool.count() != 2 or \
                parent != BERT_BASE["depth"] * parent_batches:
            fail(f"phase 38: lease replays {replays}, deaths {deaths}, "
                 f"repair {ticks}, events {events}, pool {pool.count()}, "
                 f"K2a {parent} over {parent_batches} pool transforms")
        print(f"phase 38: pool worker mesh-pool-w0 killed by worker.death "
              f"holding a lease; {answered} requests in {burst + 1} "
              f"burst(s) all 200 within phase 24's limits; leases "
              f"replayed {replays:g}, deaths detected {deaths:g}; the "
              f"autoscaler replaced it {ticks['replace'] - ticks['died']:.2f}"
              f" s after the death, inside its {MESH_COOLDOWN_S:g} s "
              f"cooldown (pool {pool.count()}, "
              f"{time.perf_counter() - t0:.2f} s)")
        injector.clear()
        pool.stop()

        # ---- the child's counts
        with open(stop_file, "w"):
            pass
        child.wait(60)
        out, err = child_log("out"), child_log("err")
        if child.returncode != 0:
            fail(f"phase 38: the child exited {child.returncode}:\n"
                 f"{out[-3000:]}\n{err[-6000:]}")
        lines = out.strip().splitlines()
        kid = json.loads(lines[-1])
        for line in lines[:-1]:
            print(line)
        misses = int(sum(kid["misses"].values()))
        problems = []
        if kid["nvcc_calls"] or kid["nvcc_runs"]:
            problems.append(f"nvcc ran: {kid['nvcc_calls']}")
        if kid["runtime_compiles"]:
            problems.append(f"runtime compiles {kid['runtime_compiles']}")
        if not kid["hits"] or misses:
            problems.append(f"hits {kid['hits']}, misses {kid['misses']}")
        if "mmlspark_flash" not in kid["loaded"]:
            problems.append(f"libraries loaded {kid['loaded']}")
        depth = BERT_BASE["depth"]
        if not kid["batches"] or kid["k2a"] != depth * kid["batches"]:
            problems.append(f"K2a {kid['k2a']} over {kid['batches']} "
                            f"transforms: expected {depth} a transform")
        if problems:
            fail("phase 38: the store-booted child: " + "; ".join(problems))
        share = kid["batches"] / (kid["batches"] + pstate["batches"])
        print(f"phase 38: the child served {kid['batches']} of "
              f"{kid['batches'] + pstate['batches']} batches ({share:.4f}; "
              f"the in-process pool {pstate['batches']}); child K2a "
              f"{kid['k2a']} = {depth} x {kid['batches']}, nvcc 0, runtime "
              f"compiles 0, store hits {int(sum(kid['hits'].values()))}, "
              f"misses 0; first reply {first_s:.2f} s after the spawn "
              f"({kid['first_reply_s']:.2f} s by the child's clock)")
        for front, r in load.items():
            print(f"phase 38: BERT-base through the mesh, {front} ingest: "
                  f"{r['throughput_rps']:,.1f} rows/s, p50 "
                  f"{r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms; {card}")
        print(f"phase 38: K2a in the mesh: the child {kid['k2a']}, this "
              f"process's pool workers {parent} over {parent_batches} "
              f"transforms")
        del stage, module
        return {"launches": kid["k2a"] + parent}
    finally:
        injector.clear()
        for fn in stops:
            fn()
        if child is not None and child.poll() is None:
            open(os.path.join(tmp, "stop"), "w").close()
            try:
                child.wait(20)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()
        for ing in ingests.values():
            ing.stop()
        if driver is not None:
            driver.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


PARALLEL_RANKS = 2            # phase 39: ranks on the one card (gloo)
PARALLEL_TIMEOUT = 240.0      # seconds the ranks may take in all
PARALLEL_TP_STEPS = 3         # tp pretraining steps held against one rank
PARALLEL_LOSS_RTOL = 1e-3     # each of those steps' loss, relative
PARALLEL_DP_DOCS = 33         # the dp featurizer's documents: one pad row
PARALLEL_ATTN_OF_MAX = 2 ** -6  # ring attention against one rank's kernel:
# max |diff| over max |o| at bf16 (two bf16 partials merged in f32 and
# rounded once more; a planted fault moves o by O(max |o|))
PARALLEL_MAX_S = 75.0         # phase 39 alone


def bert_rows(texts, lengths) -> np.ndarray:
    """Phase 24's WordPiece rows of ``texts`` (their first fifth)."""
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.featurize import WordPieceTokenizerModel
    docs = np.asarray([" ".join(t.split()[:n // 5])
                       for t, n in zip(texts, lengths)], object)
    tok = WordPieceTokenizerModel.from_vocab(
        wordpiece_vocab(texts), maxLength=BERT_BASE["max_len"],
        inputCol="text")
    return np.asarray(tok.transform(DataFrame({"text": docs}))["tokens"],
                      np.int32)


def bert_base_loaded(torch, dtype):
    """Phase 24's seeded BERT-base as a ``LoadedModel`` in ``dtype``."""
    from mmlspark_torch.models import (LoadedModel, bert_encoder_from_torch,
                                       register_bert_encoder)
    module = bert_encoder_from_torch(
        bert_state_dict(torch), config={"num_attention_heads":
                                        BERT_BASE["heads"]}, dtype=dtype)
    schema = register_bert_encoder("BertBase", seq_len=BERT_BASE["max_len"],
                                   **BERT_BASE)
    return LoadedModel(schema, module)


def gathered_grads(torch, model, shardings) -> dict:
    """{parameter: f32 gradient} with each sharded block all-gathered."""
    from mmlspark_torch.parallel.partition import gather_local
    out = {}
    for n, p in model.named_parameters():
        sh = (shardings or {}).get("params/" + n.replace(".", "/"))
        g = p.grad if sh is None else gather_local(p.grad, sh)
        out[n] = g.float()
    return out


def ring_against_one(torch, k2, mesh, q, k, v, mask, causal, impl="flash"):
    """max |ring - one rank's kernel| / max |one rank's| for the ring over
    ``mesh``'s sp axis on this rank's blocks of q, k, v, mask (every rank
    holds the whole tensors)."""
    from mmlspark_torch.parallel import make_ring_attention
    from mmlspark_torch.parallel.collectives import allgather
    from mmlspark_torch.parallel.mesh import axis_rank, axis_size
    n, r = axis_size(mesh, "sp"), axis_rank(mesh, "sp")
    t = q.shape[2] // n
    sl = slice(r * t, (r + 1) * t)
    with torch.inference_mode():
        o = make_ring_attention(mesh, causal=causal, local_impl=impl)(
            q[:, :, sl], k[:, :, sl], v[:, :, sl], mask[:, sl])
        o = allgather(o, "sp", mesh=mesh, gather_axis=2).float()
        want = k2.flash_attention(q, k, v, key_mask=mask,
                                  causal=causal).float()
    return float((o - want).abs().max() / want.abs().max())


def parallel_work(torch, rank, world, device, cfg) -> dict:
    """One rank's share of phase 39 (see :func:`parallel_phase`). Rank 0
    also runs the one-rank references while the others wait."""
    import copy

    import torch.distributed as dist
    import mmlspark_torch.dl.flash_attention as k2
    import mmlspark_torch.dl.train as train
    import mmlspark_torch.parallel.ring_attention as ring
    import mmlspark_torch.parallel.sharding as sharding
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.dl import (MaskedLMModel, TextEncoder,
                                   TextEncoderFeaturizer, TrainState,
                                   make_attention_fn, make_train_step,
                                   mask_batch, masked_xent,
                                   pretrain_masked_lm)
    from mmlspark_torch.dl.pretrain import sharded_masked_xent
    from mmlspark_torch.featurize import TokenIdEncoder
    from mmlspark_torch.parallel import (DtypePolicy, MeshSpec, build_mesh,
                                         partition_rules_for)

    cuda = device == "cuda"
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda else \
        torch.device("cpu")
    shape, T, B = cfg["text_shape"], cfg["T"], cfg["B"]
    vocab, depth = shape["vocab"], shape["depth"]
    tp_spec = MeshSpec(**cfg.get("tp_mesh", {"dp": 1, "tp": world}))
    mesh_sp = build_mesh(MeshSpec(dp=1, sp=world), device=device)
    mesh_tp = build_mesh(tp_spec, device=device)
    out = {"problems": [], "seconds": {}, "counts": {}, "peak": {}}
    lead = rank == 0

    def problem(msg):
        if lead:
            out["problems"].append(msg)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def reset_peak():
        if cuda:
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() if cuda else 0

    counters = causal_counters(k2)

    def timed(name, fn):
        """fn() with the launch counters zeroed before and read after."""
        zero_counts(counters)
        reset_peak()
        sync()
        t0 = time.perf_counter()
        result = fn()
        sync()
        out["seconds"][name] = time.perf_counter() - t0
        out["counts"][name] = {k: v for k, v in read_counts(counters).items()
                               if v}
        out["peak"][name] = peak()
        return result

    def one_step(model, loss_fn, x, y, mesh=None, placed=None):
        """One step at learning rate 0 (the gradients stay in .grad)."""
        opt = torch.optim.SGD(model.parameters(), lr=0.0)
        state = TrainState(model, opt)
        if placed is not None:
            state, sh = train.partition_train_state(state, mesh, placed)
            step = train.make_partitioned_train_step(
                model, opt, mesh, sh, loss_fn=loss_fn, fetch="logits")
        else:
            step = make_train_step(model, opt, loss_fn=loss_fn,
                                   fetch="logits", mesh=mesh)
        return state, (lambda: step(state, x, y)[1])

    def hold_grads(name, got, ref):
        if lead and not compare_grads("phase 39", name, got, ref, False,
                                      against="one rank's pallas step"):
            problem(f"{name}: gradients outside the limits of one rank's")

    texts, lengths = make_documents(cfg["docs"])
    # ---- (a) masked LM, ring_flash over sp: phase 8's model and batch
    ids = np.asarray(TokenIdEncoder(maxLength=T, vocabSize=vocab - 1)
                     .transform(DataFrame({"text": texts}))["tokens"])
    rng = np.random.default_rng(0)
    rows = ids[rng.integers(0, len(ids), size=B)]
    x, y = (torch.from_numpy(a).to(dev)
            for a in mask_batch(rows, rng, mask_id=vocab - 1))
    gen = torch.Generator().manual_seed(0)
    base = MaskedLMModel(TextEncoder(
        **shape, attention_fn=make_attention_fn("pallas"), generator=gen),
        gen)

    def with_attn(model, attn):
        m = copy.deepcopy(model)
        m.encoder = m.encoder.with_attention(attn)
        return m.to(dev)

    m = with_attn(base, make_attention_fn("ring_flash", mesh=mesh_sp))
    _, run = one_step(m, sharded_masked_xent(mesh_sp), x, y, mesh=mesh_sp)
    run()                                                   # warm
    loss = float(timed("ring_mlm", run))
    ring_grads = (loss, {n: p.grad.float() for n, p in m.named_parameters()})
    del m
    ref = None
    if lead:
        m = copy.deepcopy(base).to(dev)
        _, run = one_step(m, masked_xent, x, y)
        run()
        loss_ref = float(timed("one_rank_mlm", run))
        ref = (loss_ref, {n: p.grad.float() for n, p in m.named_parameters()})
        del m
        hold_grads(f"(a) ring_flash masked LM over sp={world}", ring_grads,
                   ref)
    del ring_grads
    dist.barrier()

    # ---- (d) tp = 2: one step's gradients (and a tp gradient left
    # unreduced), then pretrain_masked_lm over MeshSpec(dp=1, tp=2)
    rules = partition_rules_for("TextEncoderLM")
    m = copy.deepcopy(base).to(dev)
    state, run = one_step(m, sharded_masked_xent(mesh_tp), x, y,
                          mesh=mesh_tp, placed=rules)
    loss = float(timed("tp_step", run))
    got = (loss, gathered_grads(torch, m, state.shardings))
    hold_grads(f"(d) {tp_spec} step", got, ref)
    del m, got, state
    real_reduce = train._reduce_grads

    def unreduced_tp(model, shardings, mesh):
        """The planted fault: gradients summed over every replicating axis
        but tp."""
        from torch.distributed.tensor import Replicate
        from mmlspark_torch.parallel.collectives import allreduce
        from mmlspark_torch.parallel.mesh import axis_group, axis_names
        for n, p in model.named_parameters():
            sh = shardings["params/" + n.replace(".", "/")]
            for i, a in enumerate(axis_names(mesh)):
                if a != "tp" and isinstance(sh.placements[i], Replicate):
                    p.grad.copy_(allreduce(p.grad, axis_group(mesh, a)))

    train._reduce_grads = unreduced_tp
    try:
        m = copy.deepcopy(base).to(dev)
        state, run = one_step(m, sharded_masked_xent(mesh_tp), x, y,
                              mesh=mesh_tp, placed=rules)
        got = (float(run()), gathered_grads(torch, m, state.shardings))
    finally:
        train._reduce_grads = real_reduce
    if lead and compare_grads("phase 39", "planted fault (tp gradient not "
                              "reduced)", got, ref, False,
                              against="one rank's pallas step"):
        problem("(d) the gradient limits pass a tp step whose replicated "
                "gradients are not summed over tp")
    del m, got, state, ref
    policy = DtypePolicy()
    m = copy.deepcopy(base).to(dev)
    state0 = {}

    def tp_pretrain():
        st, losses = pretrain_masked_lm(
            m, ids, steps=PARALLEL_TP_STEPS, batch_size=B, seed=0,
            mesh=tp_spec, dtype_policy=policy, device=device)
        state0["state"] = st
        return losses
    tp_losses = timed("tp_pretrain", tp_pretrain)
    st = state0.pop("state")
    full = {n: tuple(p.shape) for n, p in base.named_parameters()}
    for n, p in st.model.named_parameters():
        sh = st.shardings["params/" + n.replace(".", "/")]
        if tuple(p.shape) != sh.local_shape(full[n]):
            problem(f"(d) {n}: local block {tuple(p.shape)} after "
                    f"{PARALLEL_TP_STEPS} steps, placed as "
                    f"{sh.local_shape(full[n])}")
        if any(v.shape != p.shape for v in st.optimizer.state[p].values()
               if v.dim() > 0):
            problem(f"(d) {n}: optimizer moments off the parameter's block")
    out["tp_sharded"] = sum(1 for n, sh in st.shardings.items()
                            if n.startswith("params/")
                            and any(e is not None for e in sh.spec))
    out["tp_losses"] = tp_losses
    del m, st
    if lead:
        m = copy.deepcopy(base).to(dev)
        _, one = pretrain_masked_lm(m, ids, steps=PARALLEL_TP_STEPS,
                                    batch_size=B, seed=0, device=device)
        out["one_rank_losses"] = one
        rel = max(abs(a - b) / abs(b) for a, b in zip(tp_losses, one))
        out["tp_loss_rel"] = rel
        if rel > PARALLEL_LOSS_RTOL:
            problem(f"(d) {tp_spec} losses {tp_losses} against one "
                    f"rank's {one}: relative {rel:.3g} > "
                    f"{PARALLEL_LOSS_RTOL}")
        del m
    del base
    dist.barrier()

    # ---- (b) causal LM, causal ring_flash over sp: phase 13's model
    ids_c = np.asarray(TokenIdEncoder(maxLength=T + 1, vocabSize=vocab)
                       .transform(DataFrame({"text": texts}))["tokens"])
    rng = np.random.default_rng(0)
    rows = ids_c[rng.integers(0, len(ids_c), size=B)]
    x = torch.from_numpy(rows[:, :-1]).to(dev)
    y = torch.from_numpy(np.where(rows[:, 1:] != 0, rows[:, 1:], -1)
                         .astype(np.int32)).to(dev)
    gen = torch.Generator().manual_seed(0)
    base = MaskedLMModel(TextEncoder(
        **shape, attention_fn=make_attention_fn("pallas", causal=True),
        generator=gen), gen)
    m = with_attn(base, make_attention_fn("ring_flash", mesh=mesh_sp,
                                          causal=True))
    _, run = one_step(m, sharded_masked_xent(mesh_sp), x, y, mesh=mesh_sp)
    run()
    loss = float(timed("ring_causal", run))
    got = (loss, {n: p.grad.float() for n, p in m.named_parameters()})
    del m
    if lead:
        m = copy.deepcopy(base).to(dev)
        _, run = one_step(m, masked_xent, x, y)
        ref = (float(run()), {n: p.grad.float()
                              for n, p in m.named_parameters()})
        hold_grads(f"(b) causal ring_flash LM over sp={world}", got, ref)
        del m, ref
        # a fully masked ring step: rank 0's queries against rank 1's keys
        t = T // world
        g = torch.Generator(device=dev).manual_seed(39)
        q, k, v = (torch.randn(B, shape["heads"], t,
                               shape["width"] // shape["heads"],
                               generator=g, device=dev,
                               dtype=torch.bfloat16).requires_grad_()
                   for _ in range(3))
        o, lse = k2.flash_attention_lse(q, k, v, causal=True, q_offset=0,
                                        k_offset=t)
        (o.float().sum() + lse.sum() * 0.0).backward()
        sentinel = torch.full_like(lse, -1e30)
        out["masked_step"] = dict(
            o_zero=bool((o == 0).all()), lse_sentinel=bool(
                (lse == sentinel).all()),
            grads_zero=all(bool((a.grad == 0).all()) for a in (q, k, v)))
        if not all(out["masked_step"].values()):
            problem(f"(b) a fully masked ring step gave "
                    f"{out['masked_step']}: expected o = 0, lse = -1e30 and "
                    "zero gradients")
    del got, base
    dist.barrier()

    # ---- attention-level ring holds and two planted faults
    g = torch.Generator(device=dev).manual_seed(40)
    H, D = shape["heads"], shape["width"] // shape["heads"]
    q, k, v = (torch.randn(B, H, T, D, generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    mask = (torch.arange(T, device=dev)[None, :]
            < torch.from_numpy(np.minimum(lengths[:B], T)).to(dev)[:, None])
    errs = {name: ring_against_one(torch, k2, mesh_sp, q, k, v, mask, c)
            for name, c in (("non-causal", False), ("causal", True))}
    real_lse, real_merge = k2.flash_attention_lse, ring._merge

    def k_offset_zero(*a, **kw):
        return real_lse(*a, **dict(kw, k_offset=0))
    k2.flash_attention_lse = k_offset_zero
    try:
        errs["fault: k_offset 0, causal"] = ring_against_one(
            torch, k2, mesh_sp, q, k, v, mask, True)
    finally:
        k2.flash_attention_lse = real_lse
    ring._merge = lambda o, lse, o_i, lse_i: (o_i.float(), lse_i)
    try:
        errs["fault: lse merge keeps one side"] = ring_against_one(
            torch, k2, mesh_sp, q, k, v, mask, False)
    finally:
        ring._merge = real_merge
    out["attention"] = errs
    for name, e in errs.items():
        if (e > PARALLEL_ATTN_OF_MAX) != name.startswith("fault"):
            problem(f"ring attention, {name}: max |diff| / max |o| {e:.3g} "
                    f"against the limit {PARALLEL_ATTN_OF_MAX:.3g}")
    del q, k, v

    # ---- (c) BERT-base through ulysses_flash over sp, and (d) the dp
    # featurizer over 33 documents
    texts_b, lengths_b = make_documents(PARALLEL_DP_DOCS)
    rows_b = bert_rows(texts_b, lengths_b)
    df32 = DataFrame({"tokens": list(rows_b[:cfg["docs"]])})
    df33 = DataFrame({"tokens": list(rows_b)})
    loaded = bert_base_loaded(torch, torch.bfloat16)
    kw = dict(model=loaded, inputCol="tokens", seqChunk=128, device=device)
    uly = TextEncoderFeaturizer(attentionImpl="ulysses_flash", mesh=mesh_sp,
                                **kw)
    uly.transform(df32)
    pooled_u = timed("ulysses_bert",
                     lambda: uly.transform(df32)["features"])
    dpf = TextEncoderFeaturizer(attentionImpl="pallas",
                                mesh=MeshSpec(dp=world), **kw)
    pooled_d = timed("dp_featurizer", lambda: dpf.transform(df33)[
        "features"])
    real_unpad = sharding.unpad_rows
    sharding.unpad_rows = lambda a, n: a
    try:
        # the frame refuses a column longer than itself
        faulty = len(TextEncoderFeaturizer(attentionImpl="pallas",
                                           mesh=MeshSpec(dp=world), **kw)
                     .transform(df33)["features"])
    except ValueError as e:
        faulty = f"refused: {e}"
    finally:
        sharding.unpad_rows = real_unpad
    out["dp_rows"] = (len(pooled_d), faulty)
    if len(pooled_d) != PARALLEL_DP_DOCS:
        problem(f"(d) the dp featurizer gave {len(pooled_d)} rows for "
                f"{PARALLEL_DP_DOCS} documents")
    if faulty == PARALLEL_DP_DOCS:
        problem("(d) a featurizer that keeps its padding row passes")
    if lead:
        one = TextEncoderFeaturizer(attentionImpl="pallas", **kw)
        ref32 = one.transform(df32)["features"]
        ref33 = one.transform(df33)["features"]
        out["agreement"] = {"ulysses": agreement(pooled_u, ref32),
                            "dp": agreement(pooled_d, ref33)}
        if not pooled_agreement("phase 39 (c) ulysses_flash BERT-base",
                                pooled_u, ref32, BERT_BF16_POOLED_LIMITS):
            problem("(c) ulysses_flash rows outside phase 24's limits")
        if not pooled_agreement("phase 39 (d) dp featurizer", pooled_d,
                                ref33, BERT_BF16_POOLED_LIMITS):
            problem("(d) the dp featurizer's rows outside phase 24's limits")
    from mmlspark_torch.parallel import collectives
    out["staged"] = (collectives.staged.copies, collectives.staged.bytes)
    return out


def parallel_rank(rank, world, port, out_dir, device, cfg):
    """One rank of phase 39: joins the group over ``cfg["backend"]`` (rank
    r on card r modulo the cards there are: all on card 0 of a one-card
    machine), runs :func:`parallel_work` and writes its record."""
    import pickle
    import torch
    import torch.distributed as dist
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(cfg.get("backend", "gloo"),
                            init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        out = parallel_work(torch, rank, world, device, cfg)
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def parallel_phase(torch, args, device="cuda", cfg=None,
                   world=PARALLEL_RANKS, backend="gloo") -> dict:
    """Phase 39: sequence and tensor parallelism with 2 ranks on the card
    over gloo (NCCL refuses two ranks on one card; ``tools/
    parallel_nccl.py`` runs the same scenarios on 4 cards over NCCL).
    (a) one masked-LM step through ``ring_flash`` (K2b, K2d, K2e a ring
    step) against one rank's ``pallas`` step; (b) the causal LM through the
    causal ring (K2c-lse, causal K2d/K2e) and a fully masked ring step;
    (c) BERT-base through ``ulysses_flash`` (K2a on 6 of 12 heads); (d) a
    tp = 2 step's gradients, ``pretrain_masked_lm`` over tp = 2 under a
    dtype policy against one rank, and the dp featurizer on 33 documents;
    planted faults (k_offset 0 in the causal ring, one side of the lse
    merge dropped, a tp gradient not reduced, the padding row kept) must
    fail their checks. Returns the per-rank launch counts for the kernels
    line."""
    import pickle
    import socket
    import tempfile
    import torch.multiprocessing as mp

    cfg = dict(cfg or dict(text_shape=TEXT_SHAPE, T=TEXT_T, B=args.batch,
                           docs=args.docs), backend=backend)
    print(f"phase 39: {world} ranks on {device} over {backend}; tp mesh "
          f"{cfg.get('tp_mesh', {'dp': 1, 'tp': world})}; masked and "
          f"causal LM {cfg['text_shape']} at batch {cfg['B']} x "
          f"T={cfg['T']} ({cfg['T'] // world} a rank); BERT-base on "
          f"{cfg['docs']} and {PARALLEL_DP_DOCS} documents")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.start_processes(parallel_rank,
                                 args=(world, port, d, device, cfg),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.perf_counter() + PARALLEL_TIMEOUT
        try:
            while not ctx.join(timeout=max(deadline - time.perf_counter(),
                                           0.1)):
                if time.perf_counter() > deadline:
                    fail(f"phase 39: ranks still running after "
                         f"{PARALLEL_TIMEOUT} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            fail(f"phase 39: a rank failed: {e}")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        ranks = []
        for r in range(world):
            with open(f"{d}/rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
    spawn_s = time.perf_counter() - t0
    lead = ranks[0]
    depth = cfg["text_shape"]["depth"]
    bert_depth = BERT_BASE["depth"]
    launch = int(cfg.get("launches", device == "cuda"))
    want = {"ring_mlm": {"K2b": world * depth, "K2d": world * depth,
                         "K2e": world * depth},
            "ring_causal": {"K2c-lse": world * depth,
                            "causal K2d": world * depth,
                            "causal K2e": world * depth},
            "tp_step": {"K2b": depth, "K2d": depth, "K2e": depth},
            "tp_pretrain": {k: depth * PARALLEL_TP_STEPS
                            for k in ("K2b", "K2d", "K2e")},
            "ulysses_bert": {"K2a": bert_depth},
            "dp_featurizer": {"K2a": bert_depth}}
    problems = list(lead["problems"])
    for r, rec in enumerate(ranks):
        for name, counts in want.items():
            got = rec["counts"].get(name, {})
            expect = {k: v for k, v in counts.items()} if launch else {}
            print(f"phase 39: rank {r} {name}: {rec['seconds'][name]:.3f} s, "
                  f"launches {got}, peak {rec['peak'][name] / 2**30:.2f} GiB")
            if got != expect:
                problems.append(f"rank {r} {name}: launches {got}, expected "
                                f"{expect}")
    print(f"phase 39: rank 0's one-rank masked-LM step (the reference): "
          f"{lead['seconds']['one_rank_mlm']:.3f} s, peak "
          f"{lead['peak']['one_rank_mlm'] / 2**30:.2f} GiB")
    print(f"phase 39: ring attention against one rank's kernel, max |diff| "
          f"/ max |o| (limit {PARALLEL_ATTN_OF_MAX:.4g}): "
          + ", ".join(f"{k} {v:.3g}" for k, v in lead["attention"].items()))
    print(f"phase 39: (b) a fully masked ring step: {lead['masked_step']}")
    print(f"phase 39: (d) tp pretraining losses {lead['tp_losses']} vs "
          f"one rank {lead['one_rank_losses']} (worst relative "
          f"{lead['tp_loss_rel']:.3g}, limit {PARALLEL_LOSS_RTOL}); "
          f"{lead['tp_sharded']} parameters sharded; dp featurizer rows "
          f"{lead['dp_rows'][0]} (with the padding row kept: "
          f"{lead['dp_rows'][1]})")
    print(f"phase 39: host staging ({backend} on {device}) per rank: "
          f"{[rec['staged'] for rec in ranks]} (copies, bytes); spawn to "
          f"the ranks' end {spawn_s:.1f} s")
    if problems:
        fail("phase 39: " + "; ".join(problems))
    counts = {name: lead["counts"][name] for name in want}
    return {"flash": counts["ulysses_bert"].get("K2a", 0),
            "flash_lse": {"ring_flash masked LM step":
                          counts["ring_mlm"].get("K2b", 0),
                          "tp pretraining step":
                          counts["tp_step"].get("K2b", 0)},
            "flash_bwd_dq": {"ring_flash masked LM step":
                             counts["ring_mlm"].get("K2d", 0),
                             "tp pretraining step":
                             counts["tp_step"].get("K2d", 0)},
            "flash_bwd_dkv": {"ring_flash masked LM step":
                              counts["ring_mlm"].get("K2e", 0),
                              "tp pretraining step":
                              counts["tp_step"].get("K2e", 0)},
            "flash_lse_causal": counts["ring_causal"].get("K2c-lse", 0),
            "flash_bwd_dq_causal":
                counts["ring_causal"].get("causal K2d", 0),
            "flash_bwd_dkv_causal":
                counts["ring_causal"].get("causal K2e", 0),
            "seconds": spawn_s}


PHASE_GROUPS = ("gbdt", "text", "train", "llm", "causal", "featurize",
                "breadth", "breadth2", "breadth3", "textgen", "vision",
                "obs", "control", "compile", "tune", "serving", "mesh",
                "parallel")
# the kernels line's K2a records, which gain phases 34 and 37's launches
K2A_RECORDS = ("flash", "flash_bert", "flash_control", "flash_serving")


class Phase:
    """``with Phase("phase 3"):`` prints the seconds the phase took."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"{self.name}: {time.perf_counter() - self.t0:.1f} s")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=500_000)
    ap.add_argument("--iterations", type=int, default=20)
    ap.add_argument("--docs", type=int, default=32)
    ap.add_argument("--batch", type=int, default=TRAIN_BATCH)
    ap.add_argument("--train-steps", type=int, default=5)
    ap.add_argument("--new-tokens", type=int, default=GEN_NEW,
                    help="tokens generated per prompt in phases 10-11")
    ap.add_argument("--vision-seed", type=int, default=0,
                    help="seed of phases 29-30's ResNet-50 and ViT-B/16 "
                    "weights")
    ap.add_argument("--phases", default=",".join(PHASE_GROUPS),
                    help="phase groups to run after the build: gbdt (2-4), "
                    "text (5-6), train (7-8), llm (9-11), causal (12-13), "
                    "featurize (14-15), breadth (16-18), breadth2 "
                    "(19-21), breadth3 (22-23), textgen (24-28), vision "
                    "(29-32), obs (33: needs gbdt, train and llm), "
                    "control (34), compile (35), tune (36), serving (37), "
                    "mesh (38), parallel (39); train needs text")
    ap.add_argument("--boot-child", default=None, metavar="SPEC",
                    help=argparse.SUPPRESS)
    ap.add_argument("--tune-child", default=None, metavar="SPEC",
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-child", default=None, metavar="SPEC",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.boot_child:
        boot_child(args.boot_child)
        return
    if args.tune_child:
        tune_child(args.tune_child)
        return
    if args.mesh_child:
        mesh_child(args.mesh_child)
        return
    # the tile registry of this run and its children: a fresh file that
    # only phase 36 writes, so that a registry left in the per-user default
    # can never steer phases 1-35 and 37
    import shutil
    import tempfile
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_tune-")
    os.environ["MMLSPARK_TPU_TUNE_STORE"] = os.path.join(tune_dir,
                                                         "autotune.json")
    try:
        run(args)
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)


def run(args) -> None:
    """Phases 1-39 of the groups ``args.phases`` names."""
    groups = set(args.phases.split(","))
    if not groups <= set(PHASE_GROUPS):
        fail(f"--phases {args.phases}: groups are {', '.join(PHASE_GROUPS)}")
    if "train" in groups and "text" not in groups:
        fail(f"--phases {args.phases}: train (7-8) needs text (5-6): phase "
             "8 serves its trunk as phase 6's TextEncoderLong")

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an "
             "NVIDIA GPU")
    try:
        import mmlspark_torch.dl.flash_attention as k2
        import mmlspark_torch.dl.paged_attention as k3
        import mmlspark_torch.lightgbm.hist as k1
    except ImportError as e:
        fail(f"cannot import mmlspark_torch ({e}): run from the root of a "
             "checkout")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi("name,power.limit")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # ---- phase 1: build every kernel of the paths, one nvcc each, at once;
    # the GBDT phases need only K1, so they run while the attention kernels
    # build
    t0 = time.perf_counter()
    k1_name = "K1 (lightgbm/csrc/hist.cu)"
    build_fns = {
        k1_name: k1.build_kernel,
        "K2a, K2b, K2c (dl/csrc/flash_attn.cu)": k2.build_kernel,
        "K2d, K2e (dl/csrc/flash_bwd.cu)": k2.build_bwd_kernel,
        "K3 window (dl/csrc/paged_attn.cu)": k3.build_kernel,
        "K3 decode and combine (dl/csrc/paged_decode.cu)":
            k3.build_decode_kernel,
        "K2a-K2e and K3 window, wide head dims (dl/csrc/attn_wide.cu)":
            k2.build_wide_kernel}
    if "tune" in groups:
        build_fns["K2a, K2b, K2c tuned tiles (dl/csrc/flash_tuned.cu)"] = \
            k2.build_tuned_kernel
    if groups & {"serving", "mesh"}:
        from mmlspark_torch.native.loader import (NativeLoader,
                                                  require_httpfront)

        def build_host():
            require_httpfront()
            NativeLoader("loadgen", ["loadgen.cpp"]).load()
            return ""
        build_fns["host: the epoll front and the load generator "
                  "(native/src/httpfront.cpp, loadgen.cpp; g++)"] = build_host
    builds = start_builds(build_fns)
    print("phase 1: building every kernel (sm_90a), one nvcc each, at once")
    finish_builds({k1_name: builds.pop(k1_name)})
    print(card)
    bw, bw_src = memory_bandwidth(torch)
    print(f"memory bandwidth {bw / 1e12:.3f} TB/s ({bw_src})")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)

    records = []
    if "gbdt" in groups:
        with Phase("phases 2-4 (beside the attention kernels' builds)"):
            records.append(gbdt_phases(torch, k1, dev, bw, flush, args))
    with Phase("phase 1 (after phases 2-4)"):
        finish_builds(builds)
        print(f"phase 1: built every kernel in "
              f"{time.perf_counter() - t0:.2f} s from its start")
        print(f"  K2a/K2b/K2c design: {k2.kernel_design()}")
        print(f"  K2d/K2e design: {k2.kernel_bwd_design()}")
    texts, lengths = make_documents(args.docs)
    if "text" in groups:
        with Phase("phases 5-6"):
            records.append(text_phases(torch, k1, k2, dev, bw, flush, texts,
                                       lengths))
    if "train" in groups:
        with Phase("phases 7-8"):
            records += train_phases(torch, k1, k2, dev, bw, flush, texts,
                                    lengths, args)
    if "llm" in groups:
        records += llm_phases(torch, k1, k2, k3, dev, bw, flush, lengths,
                              args)
    if "causal" in groups:
        records += causal_phases(torch, k2, dev, bw, flush, texts, lengths,
                                 args)
    if "featurize" in groups:
        chain_launches = featurize_phases(torch, k1, dev, args)
        for rec in records:
            if rec["name"] == "hist":
                rec["chain_launches"] = chain_launches
    if "breadth" in groups:
        counts = breadth_phases(torch, k1, args)
        for rec in records:
            if rec["name"] == "hist":
                rec.update(counts)
    if "breadth2" in groups:
        counts = breadth2_phases(torch, k1, args)
        for rec in records:
            if rec["name"] == "hist":
                rec.update(counts)
    if "breadth3" in groups:
        counts = breadth3_phases(torch, k1, args)
        for rec in records:
            if rec["name"] == "hist":
                rec.update(counts)
    if "textgen" in groups:
        tg = textgen_phases(torch, k1, k2, k3, dev, bw, flush, texts,
                            lengths, args)
        records.append(tg["record"])
        for rec in records:
            if rec["name"] in ("flash_lse", "flash_bwd_dq", "flash_bwd_dkv"):
                rec["resume_launches_per_step"] = \
                    tg["resume_launches_per_step"]
            if rec["name"] == "flash_causal":
                rec["continuous_launches_per_step"] = \
                    tg["continuous_launches_per_step"]
    if "vision" in groups:
        vision = vision_phases(torch, k1, k2, k3, dev, texts, args)
        for rec in records:
            if rec["name"] not in VISION_COUNTERS:
                fail(f"vision: no launch counter for the {rec['name']} "
                     "record")
            rec["vision_launches"] = sum(
                vision[c] for c in VISION_COUNTERS[rec["name"]])

    if "obs" in groups:
        if not {"gbdt", "train", "llm"} <= groups:
            fail("phase 33 (obs) needs the gbdt, train and llm groups: it "
                 "reuses phases 3, 8 and 11's data and models")
        with Phase("phase 33"):
            obs_phase(torch, k1, k2, k3, dev, card)

    if "control" in groups:
        with Phase("phase 34"):
            control = control_phase(
                torch, k2, dev, bw, flush, texts, card,
                need_record=not any(rec["name"] in K2A_RECORDS
                                    for rec in records))
        records += [control["record"]] if "record" in control else []
        for rec in records:
            if rec["name"] in K2A_RECORDS:
                rec["control_launches"] = control["launches"]

    if "compile" in groups:
        with Phase("phase 35"):
            launches = compile_phase(torch, k1, k2, k3, dev, card)
        for rec in records:
            if rec["name"] in launches:
                rec["compile_launches"] = launches[rec["name"]]

    if "serving" in groups:
        with Phase("phase 37"):
            serving = serving_phase(
                torch, k1, k2, dev, bw, flush, texts, card,
                need_record=not any(rec["name"] in K2A_RECORDS
                                    for rec in records))
        records += [serving["record"]] if "record" in serving else []
        for rec in records:
            if rec["name"] in K2A_RECORDS:
                rec["serving_launches"] = serving["launches"]

    if "mesh" in groups:
        with Phase("phase 38"):
            mesh = mesh_phase(torch, k1, k2, dev, texts, card)
        if not any(rec["name"] in K2A_RECORDS for rec in records):
            tokens = control_traffic(texts)[0][:MESH_REQUESTS]
            records.append({
                "name": "flash_mesh", "route": "cuda",
                "source": "mmlspark_torch/dl/csrc/flash_attn.cu",
                "replaces": "mmlspark_tpu/dl/pallas_attention.py:77",
                "launches": mesh["launches"],
                **k2a_at_bert_shape(torch, k2, dev, bw, flush,
                                    padded_rows(tokens, BERT_BASE["max_len"]),
                                    "phase 38", 38)})
        for rec in records:
            if rec["name"] in K2A_RECORDS + ("flash_mesh",):
                rec["mesh_launches"] = mesh["launches"]

    if "parallel" in groups:
        t_par = time.perf_counter()
        with Phase("phase 39"):
            parallel = parallel_phase(torch, args)
        par_s = time.perf_counter() - t_par
        if par_s > PARALLEL_MAX_S:
            fail(f"phase 39 took {par_s:.1f} s, over its {PARALLEL_MAX_S} s")
        for rec in records:
            name = "flash" if rec["name"] in K2A_RECORDS + ("flash_mesh",) \
                else rec["name"]
            if name in parallel:
                rec["parallel_launches"] = parallel[name]

    # no winner may have steered phases 1-35 and 37-39: the run's
    # registry is empty until phase 36 writes it (phase 39's ranks read
    # the same registry file)
    from mmlspark_torch.perf import autotune
    stats = autotune.lookup_stats()
    print(f"tile winners looked up in phases 1-35 and 37-39: {stats}")
    if any(stats["hits"].values()):
        fail(f"phases 1-35 and 37-39 found a tuned winner "
             f"({stats['hits']}): they must run the untuned kernels")

    if "tune" in groups:
        with Phase("phase 36"):
            tuned = tune_phase(torch, k1, k2, k3, dev, args)
        for rec in records:
            if rec["name"] in tuned:
                rec["tuned"] = tuned[rec["name"]]

    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
