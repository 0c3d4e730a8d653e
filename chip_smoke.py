#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's FALKON, FALKON-BLESS, k-fold CV, classifier,
KRR serving, streaming, online, sharded, guarded and fused paths, its Jamba
serving path, BLESS-Nystrom attention in gemma-2b, LM training (gemma-2b,
mamba2-370m), the training launcher, GPipe, the LM sharded across ranks,
MoE across the model axis, decode under a serving mesh, the reference's
padded attention heads (with BLESS cache compression under a mesh) and the
five examples on one H100 (every multi-rank phase one rank a card on a
machine of several).

    python3 chip_smoke.py            # needs one CUDA card; exits non-zero without one
    python3 chip_smoke.py --phase serve|nystrom|train|launch|shard|shard_launch|moe_shard
                         |serve_shard|padded_heads|examples
                         [--tree DIR]   # one phase alone (of DIR's checkout: an A/B of two
                                        # commits on one card)

Phases (each a plain function, so a CPU test can rehearse them at a tiny size):

  1. probe      card name, capability (must be (9, 0)), nvidia-smi name and
                power limit, CUDA version; TF32 off for matmuls and cuDNN.
  2. build      compile the nine CUDA kernels from the sources in this checkout.
  3. parity     each kernel against its plain PyTorch version on the card, at
                ragged shapes, all five kernel families, plus bf16 on the
                gaussian family: K1 gram, K2 falkon_matvec, K3 knm_t, K4
                knm_matvec at n = 70 001, M = 1 000, d = 18 (k vector and 3);
                K7 falkon_matvec_masked there with a vector and an (n,) mask,
                k = 3 and k = 40 with 0/1 panels, fractional weights and an
                (n,) mask broadcast to the panel; an all-zeros mask must give
                exactly 0 and an all-ones mask K2's result bit for bit; K2
                with a vector also at M = 10 000 (the cluster route on an
                8-block cluster) and M = 12 289 (just above its cap at
                d = 18: the two-stage route), K2 and K7 with k = 5 panels
                there (the two-stage route); K5 rls_score at R = 70 001,
                M in {1, 1000, 1024}; K6 quadform at n = 70 001,
                m in {1 000, 4 097}.
  4. uniform    FalkonRegressor + UniformSampler at the scale of the paper's
                SUSY experiment (d = 18, n_train = 10^6 cut from 5 * 10^6 for
                the time limit, n_test = 10^5, M = 10^4, sigma = 4, lam = 1e-6,
                20 CG iterations), on synthetic data from --seed: fit,
                predict, and predict(return_std=True) (K1 + K6 at M = 10^4);
                the kernels' launch counts are reset just before and read
                just after. The variance is refereed on 4 096 test rows by an
                fp64 TorchBackend: the CUDA variance lies no farther from it
                than the fp32 TorchBackend's, plus 1e-3 of max variance. Then
                refits on the first 65 536 rows with the same centers and the
                same lam: CudaBackend and TorchBackend in fp32, both on the
                card, refereed by a TorchBackend refit in fp64; the CUDA
                refit's predictions must lie no farther from the referee's
                than the fp32 TorchBackend's do, plus 1e-3 of max|pred|, and
                must agree to 1e-3 with a TorchBackend refit given K1's K_MM.
  5. bless      FALKON-BLESS through the front door on the same data:
                FalkonRegressor(sampler=BlessSampler(lam=1e-4, q2=3,
                m_cap=10^4), FitConfig(lam=1e-6, iters=20)), counts reset
                before the fit and read after predict. One line per ladder
                level; the ladder repeated with the same seed must give
                bit-identical centers and weights; on the final level's
                center set the CUDA scores of 4 096 candidates must agree
                with TorchBackend's.
  6. times      each kernel at the shapes the main paths gave it, against its
                plain version there (tolerance checked again), timed with CUDA
                events beside its bound and a PyTorch yardstick call: K5 at
                the largest ladder level with at most 1 024 centers, K6 at the
                predictive-variance shape (10^5 x 10^4) and at the largest
                ladder level above 1 024 centers, if there is one, and K7 at
                the sweep's shape (10^6 rows, the BLESS M, phase 7's 5-fold
                mask); K2's and K7's lines name the route matvec_plan chose,
                K3's the route of knm_t_plan, K4's that of knm_matvec_plan and
                K1's that of gram_plan. Timed and logged beside the record: K3
                at the sweep's shape (10^6 rows, the BLESS M, its 5-column
                right-hand side), K4 at the sweep's panel predict (10^6 rows,
                the BLESS M, 5 columns) and K1 at the predictive variance's
                slab (the rows of QUADFORM_SLAB_BYTES against M = 10^4), and
                phase 12's shapes: K1 on one streamed tile (65 536 training
                rows against the BLESS centers) and K4 on a serving wave of
                4 096 and of 2 048 test rows against M = 10^4.
                Logged beside them, not gated:
                K5 against K1 + K6 at M = 1 024 (the MAX_FUSED_M crossover)
                on K5's rows, and K2 on the two-stage route at M = 16 384
                (above the cluster route's cap; its first stage is K4's and
                its second K3's register route).
  7. cv         exact k-fold CV through the front door on the same data and
                phase 5's BLESS center set: KFoldSweep(folds=5, lams=(1e-5,
                1e-6, 1e-7), iters=20), counts reset just before the sweep and
                read just after. Per-fold scores, best lam, the sweep's time
                beside one naive per-fold refit's (and the naive grid's
                estimate, folds x lams x that time; printed, not gated). Gates:
                a second run repeats fold ids and scores bit for bit; on the
                first 65 536 rows with UniformSampler(m=2048) centers at lam =
                1e-3, each fold's score of a 4-fold sweep agrees within 1e-4
                relative with a naive CudaBackend refit on that fold's
                training rows, both solves converged (residual reductions
                printed); the mask tax, K7 / K2 at the sweep's shape (k = 5),
                at most 1.15 (tools/check_mask_tax.py's bound), timed in turns.
  8. classifier FalkonClassifier(FitConfig(lam=1e-6, iters=20)) on the same
                data and center set, counts reset just before the fit and read
                after the test predictions. Gates: test accuracy within 1e-3
                of 1 - phase 5's FALKON-BLESS test error (same centers, lam and
                iterations), and the two margin columns negatives of each
                other to 1e-5 of max|margin| (CG is homogeneous in b).

 12. krr-online run right after phase 8 on phase 4's data and uniform model
                and phase 5's BLESS centers, weights and fit (the LM phases
                free that memory); counts reset before the phase's work and
                read after. (a) KrrServer: 4 096 requests of 1-64 test rows
                (sizes from --seed), max_wave 4 096, min_bucket 64: every
                request's rows equal model.predict's to 1e-4 * max|pred| (K4);
                requests/s, rows/s, waves, padded rows, buckets. (b)
                AsyncKrrServer(ServeConfig(max_inflight=2)) on the same
                traffic: equal to (a) to 1e-4 * max|pred|; under one
                gram.nan_tile firing every request DONE with one wave failure
                and a split; the backend.error isolation script of
                tests/test_chaos.py replayed here gives the statuses and stats
                of its CPU run (BACKEND_ERROR_EXPECTED). (c) falkon_fit on
                ChunkStore(x, y) in pinned host memory, chunk 65 536, through
                "stream:cuda" (K1 tiles): predictions within 1e-3 * max|pred|
                of phase 5's fit on the device-resident data, allocator peak
                above the resident base < 0.25 * 4 n M. (d)
                resumable_streamed_fit on the same store, a barrier every 4
                chunks: uninterrupted, then killed by ckpt.torn_write at
                pre_rename on its third barrier and resumed; the resumed alpha
                equal bit for bit, test error < 0.2. (e) OnlineFalkon on the
                first 9 * 10^5 rows, 10 appends of 10^4 rows with a warm
                refit after each: within 1e-2 relative of (d); a NaN row
                armed with online.corrupt_row is rejected with the store, H
                and b untouched. Referee of (c)-(e): an fp64 TorchBackend fit
                on fp64 copies of the same rows, centers, weights, lam and
                iterations; the streamed predictions no farther from it than
                phase 5's K2 fit is, plus 1e-3 of max|fp64 pred|, the durable
                and online ones (fp64 accumulators) within 1e-4 of it. Runs
                before phases 9-11 in main().
 13. core-rest  run right after phase 12, on phase 4's data and phase 5's
                BLESS centers and fit; counts reset before the phase and read
                after (plus its ranks'). (a) falkon_fit through ShardedBackend
                in a one-rank NCCL group (file:// rendezvous): alpha bit for
                bit the CudaBackend refit's, which must be phase 5's, with the
                same K1, K2, K3 launches. (b) ranks in processes of their own
                (placed as in every multi-rank phase, below): one a card
                over NCCL on a machine of several cards (four: 2.5 * 10^5
                rows each), else two sharing the card over gloo (5 * 10^5
                rows each); K2, K3, K4 on their rows. The ranks' alpha and
                predictions equal bit for
                bit; predictions no farther from phase 12's fp64 referee than
                phase 5's K2 fit, plus 1e-3; test error within 1e-3 of phase
                5's; default_backend(n=10^6) in the group is ShardedBackend.
                (c) GuardedBackend(): alpha bit for bit the refit's, the same
                launches, no backend_fallback event; around a FaultyBackend
                that raises on its 5th quadratic call: one event naming no
                fallback, and the fit raises (the plain version never serves
                the card's tensors). (d) the fused fit (TorchBackend, so one
                CUDA graph per bucket) on 999 000 rows, then on 998 000 at
                lam 1e-5 and sigma 5: one capture, then none; each fit's test
                predictions no farther from an fp64 host-loop fit on the same
                inputs than the fp32 host loop's, plus 1e-3 of max|pred|; the
                second fit's predictions within 1e-3 of max|pred| of the host
                loop's.

  9. lm parity  K8 flash_attention and K9 ssd against their plain versions on
                the card, fp32 and bf16: K8 causal and bidirectional, GQA
                groups 1, 4, 6 and 8, S in {1, 1 000, 2 053}, D in {17, 32,
                80, 128} (D = 17 and S = 1 run the tensor-core kernel's
                padding), Jamba's layer (B = 4, Hq = 32, Hkv = 8, S = 2 048,
                D = 128), the reference's padded heads where the main path
                runs them (granite-moe's prefill in phase 20 (a), B = 2,
                Hq = 32, Hkv = 8, S = 512, D = 64; a qwen2-vl rank's in
                20 (b), B = 2, Hq = 4, Hkv = 1, S = 1 280, D = 128) and
                llama4-scout's (B = 1, Hq = 48, Hkv = 8, S = 1 024,
                D = 128); the wide tiles: D = 256 causal and bidirectional
                at S in {1, 1 000, 2 053}, gemma-2b's layer at its 16 padded
                q heads (B = 2, Hq = 16, Hkv = 1, S = 2 048, D = 256: phase
                15; B = 1, S = 8 192: phase 14's exact prefill) and at its
                8 published ones, and the ragged D = 129 and 200;
                K9 at S not a multiple of the chunk, at S = 4 100
                (the state carried over 65 chunks, H = 12 not a multiple of
                the 8-head scan group), Jamba's layer (B = 4, S = 2 048,
                H = 128, P = 64, N = 16) and mamba2-370m's (B = 4, S = 2 048,
                H = 32, P = 64, N = 128), y and the final state. Then K8 at
                gemma-2b's layer and K9 at mamba2-370m's, bf16 and fp32:
                parity and times beside the bound, the plain version and (K8)
                scaled_dot_product_attention.
 10. decode     jamba-v0.1-52b at full width cut to 8 layers (one period
                group: the 32 layers' 104 GB in bf16 exceed the card), fp32,
                capacity_factor 16 (no drops), random weights from --seed:
                prefill_logits on one 128-token prompt (K8 + K9) against 128
                decode_step calls (no kernel) on the same tokens; counts reset
                before each and read after.
 11. serve      the same model in bf16 at the config's capacity_factor:
                prefill_logits on 4 prompts of 2 048 tokens timed warm
                (prefill tokens/s), then ServeEngine(max_len=256,
                batch_slots=4): three 32-token requests start, a fourth joins
                after 8 steps, 32 decode steps (decode tokens/s, each slot's
                tokens); counts reset before the prefill and read after the
                serving. Then K8 and K9 at the shapes the prefill gives them
                (taken from the config) in the model's dtype: parity, and
                times beside the bound, the plain version and (K8)
                scaled_dot_product_attention; K9 also at the wrapper's
                default chunk (128) beside the model's (64), each beside the
                one-pass bound and its design's bound (the chunk states it
                writes and reads, the second read of x, B and dt).
 14. nystrom    gemma-2b at full width and depth (18 layers, bf16, random
                weights from --seed) with attention_impl="bless_nystrom" and
                1 024 landmarks: (a) prefill_logits on one 8 192-token
                prompt, timed warm, beside the same model with exact
                attention (K8 at D = 256); counts reset before each. (b) The
                first layer's q, k, v at that prompt in fp32: nystrom_attention
                on the card against the CPU, landmark sets equal per (b, kv
                head) but for ties at the selection's edge (scores within the
                RLS tolerance of the m-th), outputs within 1e-3 of max|out|;
                its error against exact attention logged. (c)
                bless_compress_cache of that layer's k, v to 1 024 rows: the
                CPU's selection; its time logged.
 15. train      repro_torch.training on SyntheticLM batches, AdamW (cosine,
                three warmup steps, clip 1.0), counts reset before each
                step. (a) gemma-2b, full width and depth, bf16, remat, 6
                steps of 2 x 2 048 tokens (8 loss chunks), peak lr 5e-4;
                (d) the state saved with repro_torch.checkpoint, a 7th step at
                microbatches = 2, the checkpoint restored into the state and
                the 7th step again: the same loss bits. (b) mamba2-370m, full
                width and depth (48 layers, N = 128), 6 steps of 4 x 2 048
                tokens, peak lr 1e-3. Gates: finite loss and grad_norm at
                every step, the loss of each of two SyntheticLM batches no
                step trains on (HELD_OUT) lower after the 6 steps than
                before them, K8 (K9) launched twice per
                attention (Mamba) layer and step (remat), every plain call on
                the card a backward recompute. (c) One fp32 loss and gradient
                of each, cut to 2 layers, B = 1, S = 256, on the card against
                the CPU: loss within 1e-4 relative, each gradient within
                1e-3 of its max|g|.
 16. launch     mamba2-370m at full width and depth (48 layers, bf16, K9 in
                every layer). (a) `python -m repro_torch.launch.train --steps
                2 --batch 4 --seq 2048 --ckpt-every 1 --log-every 1` (cut
                from 8, 4 and 4, 2 for the script's time limit) as a
                subprocess into D1; again into D2, SIGKILLed once step 1's
                checkpoint has committed, and relaunched with the same
                flags. Gates: the relaunch restores at step 1; every
                logged step's loss and grad norm finite; K9 launched twice
                per layer and step (remat; each launcher resets its counts
                before a step and logs them); the step-2 checkpoints of D1
                and D2 the same bits, every tensor of params and optimizer
                state. Printed: tokens/s, median step, stragglers, save and
                restore times, and beside them the dry run's per-rank bytes
                of the cell on a mesh of one rank and the launcher's
                torch.cuda.max_memory_allocated. (b) GPipe over two ranks
                (subprocesses, file:// rendezvous; stage r on card r over
                NCCL where the machine has two cards, else sharing one),
                24 / 24 blocks of the model in fp32 built from --seed on
                each rank, 4 microbatches of (1, 1 024) tokens of
                SyntheticLM embeddings, loss = sum(out^2). Gates: the output
                within 1e-5 and each stage param's gradient within 1e-4,
                relative to the largest value, of the 48 blocks run in
                sequence, microbatch by microbatch, in this process; each
                rank's CollectiveMeter bytes the count from the shapes
                ((S + M - 1) activations handed on forward and again
                backward, one (M, 1, 1 024, d) buffer summed); K9 launched
                in every block of every step on each rank.
 17. shard      the LM sharded across ranks (``sharding.collectives``: FSDP
                over data, tensor parallelism over model), four ranks: one a
                card over NCCL on a machine of four, else sharing the card
                over gloo. (a) `torchrun --nproc-per-node
                4 -m repro_torch.launch.train --mesh local` (data = 4) on
                mamba2-370m at full width and depth, bf16, 2 steps of 4 x
                2 048 tokens (one row a rank), a checkpoint after each
                (gathered to rank 0); once through, once SIGKILLed (the
                whole process tree) after step 1's checkpoint and
                relaunched (--phase shard_launch: 8 steps, a checkpoint
                every 4). Gates: the last step's checkpoints the same bits
                in every leaf; step 1's loss within 1e-3 relative of phase
                16's one-rank launcher; each rank's state bytes the dry
                run's for MeshShape(("data", "model"), (4, 1)); K9 launched
                twice per layer and step on every rank. Printed: each
                rank's peak memory, tokens/s. (b) One fp32 step of
                make_train_step on a (data 2, model 2) mesh, one row of 512
                tokens a data rank, of qwen3-32b at full width cut to 1
                layer (K8 on 32 q / 4 kv heads a rank) and of mamba2-370m
                at full width and depth (K9 on 16 of 32 heads; its gate
                refereed by the same step on the host CPU), the weights
                built from --seed here and read by each rank from a
                one-rank checkpoint; then the same step unsharded on the
                card once the ranks have exited. Gates: loss within 1e-5
                relative; every gradient (each rank's blocks, from AdamW's
                first mu on both sides) within 1e-4 of its max; each rank's
                CollectiveMeter bytes the closed form shard_step_bytes; K8
                and K9 launched in every layer on every rank (twice: remat).
 18. moe_shard  MoE across the model axis: one fp32 gradient
                (loss_and_grads, no optimizer state) on a (data 2, model 2)
                mesh of four ranks (one a card or sharing it), one row of 512
                tokens a data rank, each rank's blocks drawn from --seed
                leaf by leaf, against the same gradient unsharded on the
                card once the ranks have exited. jamba-v0.1-52b at full
                width cut to 2 layers (Mamba + dense MLP, Mamba + MoE; ep:
                8 of 16 experts a rank; K9 in both) and granite-moe-3b-a800m
                cut to 1 layer (tp forced: 256 of each of the 40 experts'
                512 ff columns a rank, top_k 8; K8 on 16 of its 32 padded q
                / 4 of 8 kv heads); with one rank a card also
                llama4-scout-17b-a16e cut to 1 layer (ep: 8 of 16 experts
                a rank, top_k 1 and a shared expert; 40 q heads padded to
                48 over 8 kv heads; ~4.3e9 parameters). Gates: loss within
                1e-5 relative; every gradient leaf within 1e-4 of its max (a
                leaf 0 in exact arithmetic, the top_k = 1 router's, 0 on both
                sides within 1e-6 of the model's largest); each rank's bytes
                shard_step_bytes (no norm); K8 / K9 in every layer on every
                rank, twice (remat). Printed: peak memory, dropped share.
 19. serve_shard decode under the serving mesh (sharding.serve_ctx), four
                ranks (one a card over NCCL, each drawing its blocks from
                --seed at once; or sharing the card over gloo, (a)'s ranks
                drawing one at a time), fp32. The unsharded model runs
                first on the card, every decode_step call recorded with its
                tokens, positions and logits; then the ranks run the same
                entry points with their own tokens and MoE routing, each
                call held to the unsharded call of the same index. (a)
                jamba-v0.1-52b at full width cut to 5 layers (4 Mamba, 1
                attention, 2 MoE in ep: every kind of layer of its 8-layer
                period, whose 4 MoE layers exceed the card in fp32 on four
                ranks), (data 2, model 2), seq_model, cache 2 048:
                prefill_logits of 4 x 32 tokens (K8, K9 on every rank);
                ServeEngine with 4 slots: 2 requests of 32 tokens, a third
                after 2 steps, 8 steps. (b) gemma-2b at full width cut to
                9 of its 18 layers, one sequence, seq_shard_wide over all four ranks,
                cache 32 768: prefill_logits of 128 tokens (K8), prefill,
                8 greedy steps ((a)'s steps cut from 16, (b)'s from 32 and
                16, for the script's time limit). Gates: prefill_logits and
                every decode call's logits within 1e-4 of max, every call
                fed the
                unsharded call's tokens and positions, the same outputs
                (the engine's tokens per slot, the greedy tokens); each
                rank's cache bytes the dry run's, its bytes a step
                decode_step_bytes, no plain call on the card in the
                forward.
 20. padded_heads the reference's attention layout: q heads padded to a
                multiple of 16 (under MHA the kv heads with them), q head h
                reading kv head h // (padded q heads // kv heads), the
                padded heads masked before wo; fp32, weights from --seed.
                (a) granite-moe-3b-a800m at full width and depth (32 layers,
                24 q heads padded to 32 over 8 kv heads: group 4, where the
                published grouping is 3), on the card alone: prefill_logits
                of 2 x 512 tokens (K8), then ServeEngine with 2 slots, each
                fed 16 tokens of its row, and 16 greedy steps; refereed by
                an MHA copy of the same weights whose wk / wv columns are
                repeated by the reference's head map (K8 at group 1). (b)
                qwen2-vl-2b at full width cut to 4 layers (12 q heads padded
                to 16 over 2 kv heads: group 8), (data 1, model 4), four
                ranks (one a card over NCCL on a machine of four, else
                sharing the card over gloo), model rank 3 holding only the padded heads
                12-15: prefill_logits of 2 x 1 280 tokens (the first 1 024
                the image's patch embeddings, M-RoPE), 8 decode calls on a
                cache of 1 024 rows over model whose rows were filled from
                the seed first, then bless_compress_cache of every layer's
                blocks to 256 rows, each rank keeping its 64. Gates: the
                logits of every prefill and decode call within 1e-4 of max
                of the referee's (a) or the unsharded run's (b), the same
                greedy tokens (a); each rank's compressed blocks bit for bit
                the unsharded call's on the card of the cache the ranks
                hold; each rank's cache bytes the dry run's and its bytes a
                step decode_step_bytes (b); K8 in every layer of each
                prefill, no plain call on the card.
 21. examples   the five examples/*_torch.py scripts users run, each main in
                this process on the card at its default sizes (train_lm cut
                to 8 steps; serve_batched also on Jamba's smoke config, for
                a Mamba layer), counts reset before each: quickstart (BLESS
                ladder, R-ACC against exact_rls, FALKON-BLESS, matern32 with
                the exact-RLS sampler, multi-output and KFoldSweep),
                falkon_endtoend (BLESS, then data-parallel FALKON on a group
                of one; a checkpoint), serve_krr (KrrServer), serve_batched
                (training, ServeEngine, bless_compress_cache), train_lm (the
                launcher); beside them falkon_endtoend with --device cpu at
                the same seed and size, in a process of its own. Gates:
                every example returns numbers, all finite; K5 in BLESS, K1 /
                K2 / K3 in the fits, K4 in predict and serving, K7 in the
                sweep, K8 / K9 in the LM forward launched; every plain K8 /
                K9 call on the card a backward recompute; the test errors
                of falkon_endtoend on the card and on the CPU within 1e-2.

Multi-rank phases (13 (b), 16 (b), 17 (b), 18, 19, 20 (b)) place every rank
by one rule (rank_route): its own card over NCCL when the machine has a
card for every rank, else the shared card over gloo; each logs
"route=nccl per card" or "route=gloo shared", its world and its wall time.
The script needs one card; on a machine of four cards every
multi-rank phase takes the per-card route and phase 18 adds llama4-scout.

Tolerances: Gram 2e-5 absolute; K_nM contractions (K7 too) and the
quadratic form 1e-4 * max|ref|; RLS scores 5e-4 relative + 5e-5 (tests/test_backend.py's
form); bf16 3e-2 * max|ref|; end-to-end predictions and variances 1e-3 *
max (beyond the fp32 TorchBackend's own distance from the fp64 referee);
K8 2e-5 (bf16 2e-2) and K9 2e-4 (bf16 3e-2) * max|ref| (tests/test_kernels.py),
and K8 also per query row: max|out_row - ref_row| <= the same factor *
max|ref_row| (a causal row over many keys has outputs far below row 0's);
decode against forward 5e-3 * max|logit| (tests/test_models.py); the
sharded LM (phases 17-19) 1e-5 relative loss, 1e-4 * each gradient's max,
decode logits 1e-4 * max (fp32) against the unsharded run (phase 20 too,
(a) against its referee); Nystrom attention card against CPU 1e-3 *
max|out|; a training step's loss card against CPU 1e-4 relative, each
gradient 1e-3 * its max|g|.
Any failed phase exits non-zero. The line before the last is the kernels'
JSON record; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import time

import torch

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

FAMILIES = ["gaussian", "laplacian", "linear", "matern32", "cauchy"]
GRAM_TOL = 2e-5
KNM_TOL = 1e-4
SCORE_RTOL, SCORE_ATOL = 5e-4, 5e-5
BF16_TOL = 3e-2
E2E_TOL = 1e-3
#: NVIDIA H100 SXM data-sheet peaks (dense, non-tensor fp32; dense bf16 on
#: the tensor cores; HBM3).
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_TENSOR_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

#: kernel name -> (CUDA source, the TPU kernel it replaces).
KERNELS = {
    "gram": ("src/repro_torch/kernels/gram/gram.cu",
             "src/repro/kernels/gram/gram.py:45"),
    "falkon_matvec": ("src/repro_torch/kernels/falkon_matvec/falkon_matvec.cu",
                      "src/repro/kernels/falkon_matvec/falkon_matvec.py:93"),
    "falkon_matvec_masked": ("src/repro_torch/kernels/falkon_matvec/falkon_matvec.cu",
                             "src/repro/kernels/falkon_matvec/falkon_matvec.py:139"),
    "knm_t": ("src/repro_torch/kernels/falkon_matvec/falkon_matvec.cu",
              "src/repro/kernels/falkon_matvec/falkon_matvec.py:184"),
    "knm_matvec": ("src/repro_torch/kernels/falkon_matvec/falkon_matvec.cu",
                   "src/repro/kernels/falkon_matvec/falkon_matvec.py:221"),
    "rls_score": ("src/repro_torch/kernels/rls_score/rls_score.cu",
                  "src/repro/kernels/rls_score/rls_score.py:65"),
    "quadform": ("src/repro_torch/kernels/quadform/quadform.cu",
                 "src/repro/kernels/quadform/quadform.py:51"),
}
#: the LM kernels (phases 9-11), as KERNELS (which holds the FALKON paths' seven).
LM_KERNELS = {
    "flash_attention": ("src/repro_torch/kernels/flash_attention/flash_attention.cu",
                        "src/repro/kernels/flash_attention/flash_attention.py:67"),
    "ssd": ("src/repro_torch/kernels/ssd/ssd.cu", "src/repro/kernels/ssd/ssd.py:81"),
}
#: the reference tests' tolerances (tests/test_kernels.py), scaled to max|ref|.
ATTN_TOL, ATTN_BF16_TOL = 2e-5, 2e-2
SSD_TOL, SSD_BF16_TOL = 2e-4, 3e-2
#: decode against forward (tests/test_models.py's tolerance), scaled to max|logit|.
DECODE_TOL = 5e-3
#: the one configuration of the repo that runs both LM kernels.
LM_ARCH = "jamba-v0.1-52b"
#: the kernels each main path must launch (K6 also on the BLESS path when a
#: ladder level holds more than 1 024 distinct centers).
UNIFORM_PATH = ("gram", "falkon_matvec", "knm_t", "knm_matvec", "quadform")
BLESS_PATH = ("gram", "falkon_matvec", "knm_t", "knm_matvec", "rls_score")
CV_PATH = ("gram", "falkon_matvec_masked", "knm_t", "knm_matvec")
CLASSIFIER_PATH = ("gram", "falkon_matvec", "knm_t", "knm_matvec")
#: K7 / K2 at the same shape, both timed in the same run (tools/check_mask_tax.py).
MASK_TAX_BOUND = 1.15
CV_RTOL = 1e-4


class PhaseError(RuntimeError):
    """A phase found a wrong result."""


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# 1. probe / 2. build
# ---------------------------------------------------------------------------


def probe() -> dict:
    """Card facts; raises unless a Hopper (9, 0) card is present."""
    if not torch.cuda.is_available():
        raise PhaseError("no CUDA device")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"name": name, "capability": list(cap), "nvidia_smi": smi,
            "cuda": torch.version.cuda, "torch": torch.__version__,
            "count": torch.cuda.device_count(),
            "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
    log(f"probe: {json.dumps(info)}")
    log(smi)
    if tuple(cap) != (9, 0):
        raise PhaseError(f"expected compute capability (9, 0), got {cap}")
    return info


def build_kernels() -> dict:
    """Compile every kernel (one cpp_extension.load; ninja runs the
    compilers in parallel) and print the seconds it took."""
    from repro_torch.kernels import build

    info = build.build()
    log(f"build: {info['seconds']:.1f} s (torch.utils.cpp_extension.load of "
        f"{', '.join(build.SOURCES)})")
    return info


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def make_data(n: int, d: int, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """SUSY-shaped synthetic classification data made on ``device``: x ~ N(0, I_d),
    y = sign(tanh(x.w + 0.7 sin(2 x_0) x_1) + 0.3 noise) in {-1, +1} (the
    ground-truth rule of benchmarks/run.py ``_classif``)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, d), generator=g, device=device)
    w = torch.randn((d,), generator=g, device=device)
    noise = torch.randn((n,), generator=g, device=device)
    margin = torch.tanh(x @ w + 0.7 * torch.sin(2 * x[:, 0]) * x[:, 1])
    y = torch.sign(margin + 0.3 * noise)
    return x, torch.where(y == 0, torch.ones_like(y), y)


# ---------------------------------------------------------------------------
# 3. kernel parity at ragged shapes
# ---------------------------------------------------------------------------


def _err(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max |ref|)."""
    if not bool(torch.all(torch.isfinite(out))):
        return math.inf, float(ref.abs().max())
    return float((out - ref).abs().max()), float(ref.abs().max())


def _row_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max over rows (the last axis) of max|out_row - ref_row| / max|ref_row|:
    K8's error scaled per query row, so that rows whose output is small (a
    causal row over many keys) are held as tightly as row 0, which sets
    max|ref|."""
    if out.numel() == 0:
        return 0.0
    if not bool(torch.all(torch.isfinite(out))):
        return math.inf
    err = (out - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)
    return float(err.max())


def _score_err(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max of |out - ref| / (SCORE_ATOL + SCORE_RTOL |ref|)):
    the scores agree when the second is at most 1."""
    if not bool(torch.all(torch.isfinite(out))):
        return math.inf, math.inf
    diff = (out - ref).abs()
    return float(diff.max()), float((diff / (SCORE_ATOL + SCORE_RTOL * ref.abs())).max())


def score_inputs(device, r: int, m: int, d: int, kind: str, sigma: float, seed: int):
    """Candidates x (r, d), a padded center set z (m, d) whose last tenth is
    invalid, and the inverse W = (K_JJ * mask + diag(reg))^-1 with reg =
    lam n A (lam n = 50, A in [0.5, 1.5)): the operands K5 and K6 get."""
    from repro_torch.kernels import gram_ops as go

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((r, d), generator=g, device=device)
    z = torch.randn((m, d), generator=g, device=device)
    mask = (torch.arange(m, device=device) < max(1, m - m // 10)).float()
    lamn = 50.0
    reg = torch.where(mask > 0, lamn * (0.5 + torch.rand((m,), generator=g, device=device)),
                      torch.ones((m,), device=device))
    kjj = go.gram_reference(z, z, sigma, kind=kind) * (mask[:, None] * mask[None, :])
    w = torch.cholesky_solve(torch.eye(m, device=device),
                             torch.linalg.cholesky(kjj + torch.diag(reg)))
    return x, z, w, mask, lamn


def kernel_parity(device, *, n: int = 70_001, m: int = 1_000, d: int = 18, k: int = 3,
                  sigma: float = 4.0, seed: int = 0, score_ms=(1, 1_000, 1_024),
                  quad_ms=(1_000, 4_097), route_ms=(10_000, 12_289)) -> dict:
    """Every kernel against its plain version on ``device``; returns
    {kernel: max abs error over the fp32 cases}; raises past a tolerance."""
    from repro_torch.kernels import falkon_matvec_ops as fo
    from repro_torch.kernels import gram_ops as go
    from repro_torch.kernels import quadform_ops as qo
    from repro_torch.kernels import rls_score_ops as ro

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, d), generator=g, device=device)
    z = torch.randn((m, d), generator=g, device=device)
    vp = torch.randn((m, k), generator=g, device=device)
    yp = torch.randn((n, k), generator=g, device=device)
    # K7's operands: k = 40 spans several column chunks on either route
    v40 = torch.randn((m, 40), generator=g, device=device)
    m_vec = (torch.rand((n,), generator=g, device=device) > 0.3).float()
    m3 = (torch.rand((n, k), generator=g, device=device) > 0.3).float()
    m40 = (torch.rand((n, 40), generator=g, device=device) > 0.3).float()
    m_frac = torch.rand((n, k), generator=g, device=device)
    masked_cases = (("vec", vp[:, 0], m_vec), (f"k={k}", vp, m3), ("k=40", v40, m40),
                    (f"k={k}/fractional", vp, m_frac), (f"k={k}/broadcast", vp, m_vec))
    worst: dict[str, float] = {}
    bad = []

    def check(name, kind, bf16, shape, out, ref):
        tag = f"{name}/{kind}{'/bf16' if bf16 else ''}/{shape}"
        if out.shape != ref.shape:
            bad.append(f"{tag}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
            return
        err, scale = _err(out, ref)
        if bf16:
            tol = BF16_TOL * max(scale, 1.0) if name == "gram" else BF16_TOL * scale
        else:
            tol = GRAM_TOL if name == "gram" else KNM_TOL * scale
            worst[name] = max(worst.get(name, 0.0), err)
        log(f"parity {tag}: max_abs_err={err:.3e} tol={tol:.3e} max|ref|={scale:.3e}")
        if not err <= tol:
            bad.append(f"{tag}: {err:.3e} > {tol:.3e}")

    for kind in FAMILIES:
        for bf16 in ([False, True] if kind == "gaussian" else [False]):
            kw = dict(kind=kind, bf16=bf16)
            check("gram", kind, bf16, f"{n}x{m}", go.gram(x, z, sigma, **kw),
                  go.gram_reference(x, z, sigma, **kw))
            for v, y, shape in ((vp[:, 0], yp[:, 0], "vec"), (vp, yp, f"k={k}")):
                check("falkon_matvec", kind, bf16, shape, fo.falkon_matvec(x, z, v, sigma, **kw),
                      fo.falkon_matvec_reference(x, z, v, sigma, **kw))
                check("knm_t", kind, bf16, shape, fo.knm_t(x, z, y, sigma, **kw),
                      fo.knm_t_reference(x, z, y, sigma, **kw))
                check("knm_matvec", kind, bf16, shape, fo.knm_matvec(x, z, v, sigma, **kw),
                      fo.knm_matvec_reference(x, z, v, sigma, **kw))
            for shape, v, mask in masked_cases:
                check("falkon_matvec_masked", kind, bf16, shape,
                      fo.falkon_matvec(x, z, v, sigma, mask=mask, **kw),
                      fo.falkon_matvec_masked_reference(x, z, v, mask, sigma, **kw))
            for shape, v, mask in masked_cases[:3]:
                tag = f"falkon_matvec_masked/{kind}{'/bf16' if bf16 else ''}/{shape}"
                ones = fo.falkon_matvec(x, z, v, sigma, mask=torch.ones_like(mask), **kw)
                zeros = fo.falkon_matvec(x, z, v, sigma, mask=torch.zeros_like(mask), **kw)
                same = torch.equal(ones, fo.falkon_matvec(x, z, v, sigma, **kw))
                nonzero = int(torch.count_nonzero(zeros))
                log(f"parity {tag}: all-ones mask bit-identical to K2 {same}, all-zeros mask "
                    f"nonzero outputs {nonzero}")
                if not same:
                    bad.append(f"{tag}: an all-ones mask is not bit-identical to K2")
                if nonzero:
                    bad.append(f"{tag}: an all-zeros mask gave {nonzero} nonzero outputs")
            sync(device)

    # K2 and K7 on both routes beyond the shapes above (which take one-block
    # clusters): a vector at M = 10 000 splits over an 8-block cluster; at
    # M = 12 289, just above the cluster route's cap at d = 18, and with k = 5
    # panels at both M, the calls take the two-stage route.
    for mm in route_ms:
        z2 = torch.randn((mm, d), generator=g, device=device)
        v2 = torch.randn((mm, 5), generator=g, device=device)
        mask2 = (torch.rand((n, 5), generator=g, device=device) > 0.3).float()
        for kind in FAMILIES:
            for bf16 in ([False, True] if kind == "gaussian" else [False]):
                kw = dict(kind=kind, bf16=bf16)
                for shape, v, mask in (("vec", v2[:, 0], None), ("k=5", v2, mask2)):
                    plan = fo.matvec_plan(n, mm, d, 1 if v.ndim == 1 else v.shape[1])
                    tag = f"{n}x{mm}/{shape}/{plan.route}/cluster={plan.cluster}"
                    check("falkon_matvec", kind, bf16, tag,
                          fo.falkon_matvec(x, z2, v, sigma, **kw),
                          fo.falkon_matvec_reference(x, z2, v, sigma, **kw))
                    if mask is not None:
                        check("falkon_matvec_masked", kind, bf16, tag,
                              fo.falkon_matvec(x, z2, v, sigma, mask=mask, **kw),
                              fo.falkon_matvec_masked_reference(x, z2, v, mask, sigma, **kw))
                sync(device)
        del z2, v2, mask2

    # K5 and K6 on the operands the backend forms: a masked center buffer and
    # the explicit inverse of its regularized K_JJ.
    for kind in FAMILIES:
        for bf16 in ([False, True] if kind == "gaussian" else [False]):
            for mm in score_ms:
                xs, zs, w, mask, lamn = score_inputs(device, n, mm, d, kind, sigma, seed + mm)
                out = ro.rls_score(xs, zs, w, mask, lamn, sigma, kind=kind, bf16=bf16)
                ref = ro.rls_score_reference(xs, zs, w, mask, lamn, sigma, kind=kind, bf16=bf16)
                tag = f"rls_score/{kind}{'/bf16' if bf16 else ''}/{n}x{mm}"
                if bf16:
                    check("rls_score", kind, bf16, f"{n}x{mm}", out, ref)
                    continue
                err, ratio = _score_err(out, ref)
                worst["rls_score"] = max(worst.get("rls_score", 0.0), err)
                log(f"parity {tag}: max_abs_err={err:.3e} max err/(atol+rtol|ref|)={ratio:.3f}")
                if not ratio <= 1.0:
                    bad.append(f"{tag}: scores differ ({ratio:.3f} of the tolerance)")
            for mm in quad_ms:
                xs, zs, w, mask, _ = score_inputs(device, n, mm, d, kind, sigma, seed + mm)
                gq = go.gram(xs, zs, sigma, kind=kind) * mask[None, :]
                check("quadform", kind, bf16, f"{n}x{mm}", qo.quadform(gq, w, bf16=bf16),
                      qo.quadform_reference(gq, w, bf16=bf16))
                del gq
            sync(device)
    if bad:
        raise PhaseError("kernel parity failed: " + "; ".join(bad))
    return worst


# ---------------------------------------------------------------------------
# 4. end to end
# ---------------------------------------------------------------------------


def end_to_end(device, *, n_train: int = 1_000_000, n_test: int = 100_000, m: int = 10_000,
               d: int = 18, iters: int = 20, sigma: float = 4.0, lam: float = 1e-6,
               refit_rows: int = 65_536, referee_rows: int = 4_096, seed: int = 0,
               max_error: float = 0.2) -> dict:
    """Fit, predict and predict with std through the front door with the
    launch counts reset just before and read just after; the variance
    referee; then the CudaBackend / TorchBackend refit agreement. Returns
    the metrics and the tensors the later phases reuse."""
    from repro_torch import kernels
    from repro_torch.api import FalkonRegressor, FitConfig, UniformSampler
    from repro_torch.core import CudaBackend, make_preconditioner

    x, y = make_data(n_train + n_test, d, seed, device)
    xtr, ytr, xte, yte = x[:n_train], y[:n_train], x[n_train:], y[n_train:]
    est = FalkonRegressor(kernel="gaussian", sigma=sigma,
                          sampler=UniformSampler(m=m, weights="identity", replace=False),
                          config=FitConfig(lam=lam, iters=iters, seed=seed, device=str(device)))
    sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    est.fit(xtr, ytr)
    sync(device)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = est.predict(xte)
    sync(device)
    predict_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred_std, std = est.predict(xte, return_std=True)
    sync(device)
    predict_std_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else None

    if pred.shape != (n_test,) or not bool(torch.all(torch.isfinite(pred))):
        raise PhaseError(f"predictions: shape {tuple(pred.shape)}, finite "
                         f"{bool(torch.all(torch.isfinite(pred)))}")
    test_error = float(torch.mean((torch.sign(pred) != yte).float()))
    reduction = float(est.model_.diagnostics.reduction.max())
    res = {"n_train": n_train, "n_test": n_test, "m": m, "d": d, "iters": iters,
           "fit_s": fit_s, "predict_s": predict_s, "predict_std_s": predict_std_s,
           "test_error": test_error, "cg_residual_reduction": reduction, "launches": launches,
           "peak_bytes": peak, "knm_bytes": 4 * n_train * m}
    log(f"end_to_end: {json.dumps(res)}")
    if not torch.equal(pred_std, pred):
        raise PhaseError("predict(return_std=True) changed the predictions")
    res["variance"] = variance_referee(est.model_, xte, std, referee_rows)
    if not test_error < max_error:
        raise PhaseError(f"test error {test_error:.4f} is not below {max_error}")
    if not reduction < 1e-2:
        raise PhaseError(f"CG reduced the squared residual only to {reduction:.3e}")
    if peak is not None and not peak < 0.25 * res["knm_bytes"]:
        raise PhaseError(f"peak device memory {peak} B is not far below K_nM's "
                         f"{res['knm_bytes']} B")
    if torch.device(device).type == "cuda":
        missing = [name for name in UNIFORM_PATH if launches[name] == 0]
        if missing:
            raise PhaseError(f"kernels not launched on the uniform path: {missing}")

    # Where the fit's time goes outside the kernels: the sampler (host draw
    # plus the gather of the centers) and the Def. 2 preconditioner (eigh of
    # the M x M K_MM), each timed once more on its own after the fit.
    t0 = time.perf_counter()
    cs = est.sampler.sample(seed, xtr, est.kernel)
    z = xtr[cs.idx[:m].to(xtr.device)]
    sync(device)
    sample_s = time.perf_counter() - t0
    kmm = CudaBackend().gram_block(est.kernel, z, z)
    sync(device)
    t0 = time.perf_counter()
    make_preconditioner(est.kernel, z, torch.ones(m, device=z.device), lam, n_train, kmm=kmm)
    sync(device)
    res["breakdown"] = {"sample_s": sample_s, "preconditioner_s": time.perf_counter() - t0}
    del kmm, z
    log(f"fit breakdown: {json.dumps(res['breakdown'])}")

    rows = min(refit_rows, n_train)
    res["refit"] = refit_agreement(est.kernel, xtr[:rows], ytr[:rows], est.centers_,
                                   est.a_diag_, xte, lam, iters)
    res["tensors"] = {"x": xtr, "z": est.centers_, "xte": xte, "y": ytr, "yte": yte,
                      "alpha": est.model_.alpha, "lamn": lam * n_train}
    return res


def variance_referee(model, xte, std, rows: int) -> dict:
    """The CUDA predictive variance (std**2 of ``predict(return_std=True)``)
    against an fp64 TorchBackend referee on the first ``rows`` test rows.

    Gates: every variance finite and >= 0; the CUDA variance no farther from
    the referee than the fp32 TorchBackend's, plus E2E_TOL * max variance.
    """
    from repro_torch.core import FalkonModel, TorchBackend

    var = std.double() ** 2
    sub = xte[:rows]
    t32 = model.predictive_variance(sub, backend=TorchBackend()).double()
    m64 = FalkonModel(centers=model.centers.double(), alpha=model.alpha.double(),
                      kernel=model.kernel, lam=model.lam, n_train=model.n_train,
                      a_diag=model.a_diag.double())
    t64 = m64.predictive_variance(sub.double(), backend=TorchBackend())
    # the CUDA path's composition in plain fp32 torch (explicit W, then
    # rowsum((G W) * G)): reported, not gated, to tell the explicit inverse's
    # rounding apart from K1's and K6's
    kern = model.kernel
    lamn = model.lam * model.n_train
    kmm = kern.cross(model.centers, model.centers) + torch.diag(lamn * model.a_diag.float())
    w = torch.cholesky_solve(torch.eye(kmm.shape[0], device=kmm.device),
                             torch.linalg.cholesky(kmm))
    g = kern.cross(sub, model.centers)
    tw = torch.clamp(kern.diag(sub) - torch.sum((g @ w) * g, dim=1), min=0.0).double()
    del kmm, w, g
    scale = float(t64.abs().max())
    res = {"rows": sub.shape[0], "max_var_fp64": scale,
           "cuda_fp64": float((var[:rows] - t64).abs().max()) / scale,
           "torch_fp64": float((t32 - t64).abs().max()) / scale,
           "torch_explicit_w_fp64": float((tw - t64).abs().max()) / scale,
           "min_var": float(var.min()), "finite": bool(torch.all(torch.isfinite(var)))}
    log(f"variance cuda vs torch, fp64 referee: {json.dumps(res)}")
    if not res["finite"] or not res["min_var"] >= 0.0:
        raise PhaseError(f"predictive variances: finite {res['finite']}, min {res['min_var']}")
    if not res["cuda_fp64"] <= res["torch_fp64"] + E2E_TOL:
        raise PhaseError(f"the CUDA variance is {res['cuda_fp64']:.3e} from the fp64 referee, "
                         f"farther than TorchBackend's ({res['torch_fp64']:.3e}) + {E2E_TOL}")
    return res


def refit_agreement(kern, x, y, z, a_diag, xte, lam: float, iters: int) -> dict:
    """CudaBackend against TorchBackend on the same rows and centers at the
    fit's own lam, with an fp64 refit as the referee.

    Four refits, each predicted on ``xte``:
      cuda      CudaBackend (K1-K4), fp32
      torch     TorchBackend, fp32
      torch_k1  TorchBackend, fp32, but K_MM from K1: the kernels' K_MM with
                torch's K_nM sweeps, which splits the K_MM rounding from the rest
      fp64      TorchBackend on fp64 copies of the same inputs: the referee
    Each distance is a max abs difference over max |fp64 prediction|. The
    gates: the CUDA refit is no farther from the referee than the fp32
    TorchBackend refit is, plus E2E_TOL; and on one K_MM (K1's) the CUDA
    sweeps and torch's agree to E2E_TOL ("cuda_torch_k1"). "cuda_torch", the
    two fp32 paths each on its own K_MM, is reported beside them: the fp32
    solve at this lam amplifies K_MM's last-bit rounding past E2E_TOL. K2
    and K3 are held against their plain versions at the refit's shape too.
    """
    from repro_torch.core import CudaBackend, TorchBackend, falkon_fit
    from repro_torch.kernels import falkon_matvec_ops as fo

    @dataclasses.dataclass(frozen=True)
    class TorchBackendK1Gram(TorchBackend):
        def gram_block(self, kernel, xa, za):
            return CudaBackend().gram_block(kernel, xa, za)

    def refit(backend, dtype=torch.float32):
        model = falkon_fit(kern, x.to(dtype), y.to(dtype), z.to(dtype), lam,
                           a_diag=a_diag.to(dtype), iters=iters, backend=backend, fused=False)
        return model, model.predict(xte.to(dtype), backend=backend)

    cuda_model, cuda = refit(CudaBackend())
    preds = {"cuda": cuda, "torch": refit(TorchBackend())[1],
             "torch_k1": refit(TorchBackendK1Gram())[1],
             "fp64": refit(TorchBackend(), torch.float64)[1]}
    sync(x.device)
    scale = float(preds["fp64"].abs().max())

    def dist(a, b):
        return float((preds[a].double() - preds[b].double()).abs().max()) / scale

    res = {"rows": x.shape[0], "lam": lam, "max_abs_pred_fp64": scale,
           "cuda_fp64": dist("cuda", "fp64"), "torch_fp64": dist("torch", "fp64"),
           "torch_k1_fp64": dist("torch_k1", "fp64"), "cuda_torch": dist("cuda", "torch"),
           "torch_k1_torch": dist("torch_k1", "torch"), "cuda_torch_k1": dist("cuda", "torch_k1")}
    v = cuda_model.alpha
    kw = dict(sigma=kern.sigma, kind=kern.name)
    parity = {"falkon_matvec": (fo.falkon_matvec(x, z, v, **kw),
                                fo.falkon_matvec_reference(x, z, v, **kw)),
              "knm_t": (fo.knm_t(x, z, y, **kw), fo.knm_t_reference(x, z, y, **kw))}
    bad = []
    for name, (out, ref) in parity.items():
        err, ref_scale = _err(out, ref)
        res[f"parity_{name}"] = {"max_abs_err": err, "tol": KNM_TOL * ref_scale}
        if not err <= KNM_TOL * ref_scale:
            bad.append(f"{name} at the refit's shape: {err:.3e} > {KNM_TOL * ref_scale:.3e}")
    log(f"refit cuda vs torch, fp64 referee: {json.dumps(res)}")
    if not all(math.isfinite(float(p.abs().max())) for p in preds.values()):
        bad.append("a refit's predictions are not finite")
    if not res["cuda_fp64"] <= res["torch_fp64"] + E2E_TOL:
        bad.append(f"the CudaBackend refit is {res['cuda_fp64']:.3e} from the fp64 referee, "
                   f"farther than the TorchBackend refit ({res['torch_fp64']:.3e}) + {E2E_TOL}")
    if not res["cuda_torch_k1"] <= E2E_TOL:
        bad.append(f"on K1's K_MM the CudaBackend and TorchBackend refits differ by "
                   f"{res['cuda_torch_k1']:.3e} > {E2E_TOL}")
    if bad:
        raise PhaseError("refit agreement failed: " + "; ".join(bad))
    return res


# ---------------------------------------------------------------------------
# 5. FALKON-BLESS at full width
# ---------------------------------------------------------------------------


def level_recorder(inner):
    """A backend that runs ``inner`` and notes, for each ``rls_scores`` call
    (one per ladder level with centers), its operands and the launches it
    made. It adds bookkeeping only, so a ladder run on it must repeat the
    fit's own ladder bit for bit."""
    from repro_torch import kernels
    from repro_torch.core import Backend

    @dataclasses.dataclass(frozen=True)
    class LevelRecorder(Backend):
        calls: list = dataclasses.field(default_factory=list, compare=False, hash=False)

        def rls_scores(self, kernel, x_cand, z, z_mask, reg, lamn):
            before = kernels.launch_counts()
            out = inner.rls_scores(kernel, x_cand, z, z_mask, reg, lamn)
            after = kernels.launch_counts()
            self.calls.append({"r": x_cand.shape[0], "dbuf": z.shape[0],
                               "launches": {k: after[k] - before[k] for k in after},
                               "args": (x_cand, z, z_mask, reg, float(lamn))})
            return out

    return LevelRecorder()


def bless_end_to_end(device, t: dict, *, sigma: float = 4.0, lam_bless: float = 1e-4,
                     q2: float = 3.0, m_cap: int = 10_000, lam: float = 1e-6, iters: int = 20,
                     seed: int = 0, score_rows: int = 4_096, max_error: float = 0.2) -> dict:
    """FALKON-BLESS through the front door on phase 4's data, with the launch
    counts reset just before the fit and read just after predict. Then the
    ladder once more with the same seed on a recording backend: one line per
    level, its time (the sampler's share of the fit), and the gate that it
    repeats the fit's centers and weights bit for bit. Then the final level's
    scores of ``score_rows`` candidates, CudaBackend against TorchBackend."""
    from repro_torch import kernels
    from repro_torch.api import BlessSampler, FalkonRegressor, FitConfig
    from repro_torch.core import CudaBackend, TorchBackend, approx_rls, make_preconditioner
    from repro_torch.core.bless import _bucket
    from repro_torch.kernels import rls_score_ops as ro

    xtr, ytr, xte, yte = t["x"], t["y"], t["xte"], t["yte"]
    n_train = xtr.shape[0]
    on_card = torch.device(device).type == "cuda"
    est = FalkonRegressor(kernel="gaussian", sigma=sigma,
                          sampler=BlessSampler(lam=lam_bless, q2=q2, m_cap=m_cap),
                          config=FitConfig(lam=lam, iters=iters, seed=seed, device=str(device)))
    sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    est.fit(xtr, ytr)
    sync(device)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = est.predict(xte)
    sync(device)
    predict_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() if on_card else None
    m = int(est.center_set_.count)

    if pred.shape != yte.shape or not bool(torch.all(torch.isfinite(pred))):
        raise PhaseError(f"FALKON-BLESS predictions: shape {tuple(pred.shape)}, finite "
                         f"{bool(torch.all(torch.isfinite(pred)))}")
    test_error = float(torch.mean((torch.sign(pred) != yte).float()))
    reduction = float(est.model_.diagnostics.reduction.max())

    # the ladder again, same seed, same backend, recorded level by level
    rec = level_recorder(est._backend())
    sync(device)
    t0 = time.perf_counter()
    ladder = est.sampler.ladder(seed, xtr, est.kernel, backend=rec)
    sync(device)
    sample_s = time.perf_counter() - t0
    repeat_equal = (torch.equal(ladder.final.centers.idx, est.center_set_.idx)
                    and torch.equal(ladder.final.centers.weight, est.center_set_.weight))
    # where the rest of the fit goes: K2 at the fit's M (one CG iteration's
    # quadratic op) and the Def. 2 preconditioner, each timed once more, warm
    z = est.centers_
    kmm = CudaBackend().gram_block(est.kernel, z, z)
    sync(device)
    t0 = time.perf_counter()
    make_preconditioner(est.kernel, z, est.a_diag_, lam, n_train, kmm=kmm)
    sync(device)
    precond_s = time.perf_counter() - t0
    del kmm
    k2_ms = None
    if on_card:
        quad = CudaBackend().knm_quadratic(est.kernel, xtr, z)
        k2_ms = _cuda_ms(lambda: quad(est.model_.alpha), 3)
    levels = []
    for h, lvl in enumerate(ladder.levels):
        call = rec.calls[h - 1] if h >= 1 else None
        row = {"lam": lvl.lam, "r_h": lvl.r_h, "rbuf": _bucket(lvl.r_h), "m_h": lvl.m_h,
               "mbuf": lvl.centers.idx.shape[0], "dbuf": call["dbuf"] if call else 0,
               "d_h": lvl.d_h,
               "k5": call["launches"]["rls_score"] if call else 0,
               "k6": call["launches"]["quadform"] if call else 0}
        levels.append(row)
        log(f"bless level {h}: {json.dumps(row)}")
    above = [c for c in rec.calls if c["dbuf"] > ro.MAX_FUSED_M]
    log(f"bless levels scored against more than {ro.MAX_FUSED_M} distinct centers: "
        f"{len(above)}")

    # the final level's own center set: CUDA scores against TorchBackend's
    final = ladder.final
    cand = xtr[:score_rows]
    cmask = torch.ones((cand.shape[0],), dtype=torch.bool, device=cand.device)
    s_cuda = approx_rls(est.kernel, cand, cmask, xtr, final.centers, final.lam,
                        backend=CudaBackend())
    s_torch = approx_rls(est.kernel, cand, cmask, xtr, final.centers, final.lam,
                         backend=TorchBackend())
    score_err, score_ratio = _score_err(s_cuda, s_torch)

    res = {"n_train": n_train, "m": m, "mbuf": est.center_set_.idx.shape[0],
           "lam_bless": lam_bless, "lam": lam, "iters": iters, "fit_s": fit_s,
           "sample_s": sample_s, "sampler_share_of_fit": sample_s / fit_s,
           "preconditioner_s": precond_s, "falkon_matvec_ms": k2_ms,
           "predict_s": predict_s, "test_error": test_error,
           "cg_residual_reduction": reduction, "launches": launches, "peak_bytes": peak,
           "knm_bytes": 4 * n_train * m, "repeat_bit_identical": repeat_equal,
           "levels_above_1024": len(above), "final_score_max_abs_err": score_err,
           "final_score_err_over_tol": score_ratio}
    log(f"bless end_to_end: {json.dumps(res)}")
    bad = []
    if not test_error < max_error:
        bad.append(f"test error {test_error:.4f} is not below {max_error}")
    if not reduction < 1e-2:
        bad.append(f"CG reduced the squared residual only to {reduction:.3e}")
    if peak is not None and not peak < 0.25 * res["knm_bytes"]:
        bad.append(f"peak device memory {peak} B is not far below K_nM's {res['knm_bytes']} B")
    if on_card:
        need = BLESS_PATH + (("quadform",) if above else ())
        missing = [name for name in need if launches[name] == 0]
        if missing:
            bad.append(f"kernels not launched on the FALKON-BLESS path: {missing}")
    if not repeat_equal:
        bad.append("the ladder repeated with the same seed gave other centers or weights")
    if not score_ratio <= 1.0:
        bad.append(f"final-level scores: CUDA vs TorchBackend {score_ratio:.3f} of the tolerance")
    if bad:
        raise PhaseError("FALKON-BLESS failed: " + "; ".join(bad))

    def largest(calls):
        return max(calls, key=lambda c: (c["dbuf"], c["r"]))["args"] if calls else None

    res["levels"] = levels
    res["tensors"] = {"k5": largest([c for c in rec.calls if c["dbuf"] <= ro.MAX_FUSED_M]),
                      "k6_ladder": largest(above), "center_set": est.center_set_,
                      "z": est.centers_, "a_diag": est.a_diag_, "alpha": est.model_.alpha}
    return res


# ---------------------------------------------------------------------------
# 6. kernel times at the main path's shapes
# ---------------------------------------------------------------------------


def bound(name: str, n: int, m: int, d: int, k: int) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations") for one call.

    Bytes: each input read once, each output written once (fp32). Operations:
    the Gram values computed once, 2d for x.z plus 3 for the distance
    (add, fma, clamp) plus 2 for the gaussian epilogue (mul, exp), and 2 per
    multiply-add of each contraction against k columns (falkon_matvec has
    two). K7 (``falkon_matvec_masked``) is K2 plus the (n, k) mask read and
    its n k multiplies. K5 (``rls_score``, n candidates against m centers) reads x, z, W,
    the mask and K_ii and writes the scores; it computes the Gram values, 2
    per multiply-add of G W, and 2 per element of the row sum with G. K6
    (``quadform``, G (n, m)) reads G and W and writes n values; 2 n m^2 + 2 n m
    operations. Over the fp32 peak and the HBM rate of the data sheet.
    """
    gram_ops = n * m * (2 * d + 5)
    if name == "gram":
        nbytes, ops = 4 * (n * d + m * d + n * m), gram_ops
    elif name == "falkon_matvec":
        nbytes, ops = 4 * (n * d + m * d + 2 * m * k), gram_ops + 4 * n * m * k
    elif name == "falkon_matvec_masked":
        nbytes = 4 * (n * d + m * d + 2 * m * k + n * k)
        ops = gram_ops + 4 * n * m * k + n * k
    elif name == "knm_t":
        nbytes, ops = 4 * (n * d + m * d + n * k + m * k), gram_ops + 2 * n * m * k
    elif name == "knm_matvec":
        nbytes, ops = 4 * (n * d + m * d + m * k + n * k), gram_ops + 2 * n * m * k
    elif name == "rls_score":
        nbytes = 4 * (n * d + m * d + m * m + m + 2 * n)
        ops = gram_ops + 2 * n * m * m + 2 * n * m
    elif name == "quadform":
        nbytes, ops = 4 * (n * m + m * m + n), 2 * n * m * m + 2 * n * m
    else:
        raise ValueError(name)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _library_call(name: str, x, z, v, s: float, block: int = 16_384, w=None, mask=None,
                  lamn: float = 1.0):
    """One PyTorch yardstick for the same function (cdist + exp + matmul),
    row-blocked where the whole K_nM would not fit. Never used by the port.
    For K5 it is the Gram + ``torch.matmul`` chain (1 - rowsum((G W) * G)) /
    lam n with G masked (K_ii = 1 for the gaussian); for K6, with ``x`` the
    given G, rowsum((G W) * G); for K7, per row block, G^T ((G V) * mask)."""
    def g(xb):
        return torch.exp(-torch.cdist(xb, z).square() * s)
    if name == "gram":
        return g(x)
    if name == "quadform":
        return torch.sum((x @ w) * x, dim=1)
    if name == "rls_score":
        gm = g(x) * mask[None, :]
        return (1.0 - torch.sum((gm @ w) * gm, dim=1)) / lamn
    if name == "knm_matvec":
        return torch.cat([g(x[i:i + block]) @ v for i in range(0, x.shape[0], block)])
    out = torch.zeros((z.shape[0],) + tuple(v.shape[1:]), device=x.device)
    for i in range(0, x.shape[0], block):
        gb = g(x[i:i + block])
        if name == "knm_t":
            out += gb.T @ v[i:i + block]
        elif name == "falkon_matvec_masked":
            out += gb.T @ ((gb @ v) * mask[i:i + block])
        else:
            out += gb.T @ (gb @ v)
    return out


def _cuda_ms(fn, repeats: int) -> float:
    """Mean ms per call over ``repeats`` calls after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def sweep_mask(n: int, folds: int, seed: int, device) -> torch.Tensor:
    """The (n, folds) training-row mask ``KFoldSweep(folds=folds, seed=seed)``
    solves with: its fold ids, from the fold generator of the seed."""
    from repro_torch.api.sweep import fold_ids, split_generators

    fid = fold_ids(split_generators(seed)[1], n, folds).to(device)
    return (fid[:, None] != torch.arange(folds, device=device)[None, :]).float()


def main_path_calls(t: dict, sigma: float, bless_t: dict, *, folds: int = 5, seed: int = 0):
    """(name, n, m, d, k, kernel call, plain call, library call) for each kernel
    at the shapes the main paths gave it: K1 builds K_MM, K2 and K3 run on
    the training rows with a vector, K4 predicts the test rows, K5 scores the
    largest ladder level with at most 1 024 centers, K6 contracts the test
    rows' Gram block against W at M = 10^4 (the predictive variance), K7 runs
    on the training rows, the BLESS centers and the sweep's (n, folds) mask
    with an (M, folds) panel; "knm_t@cv" is K3 on the training rows, the
    BLESS centers and the sweep's (n, folds) right-hand sides, "knm_matvec@cv"
    K4 on the same rows and centers with an (M, folds) panel (the sweep's
    panel predict), "gram@slab" K1 on the test rows of one predictive-variance
    slab (``QUADFORM_SLAB_BYTES``) against the M = 10^4 centers, "gram@stream"
    K1 on one of phase 12's streamed chunks (``KRR_CHUNK`` training rows
    against the BLESS centers), "knm_matvec@wave" and "knm_matvec@wave_half"
    K4 on phase 12's serving waves (``KRR_MAX_WAVE`` and half as many test
    rows against the M = 10^4 centers), and "quadform@ladder" K6 at the largest ladder level above 1 024 centers
    (timed and logged, not part of the kernels record)."""
    from repro_torch.core import CudaBackend, make_kernel
    from repro_torch.core.backend import QUADFORM_SLAB_BYTES
    from repro_torch.kernels import falkon_matvec_ops as fo
    from repro_torch.kernels import gram_ops as go
    from repro_torch.kernels import quadform_ops as qo
    from repro_torch.kernels import rls_score_ops as ro

    x, z, xte, y, alpha = t["x"], t["z"], t["xte"], t["y"], t["alpha"]
    n, d = x.shape
    m = z.shape[0]
    s = 1.0 / (2.0 * sigma ** 2)
    v = alpha
    kern = make_kernel("gaussian", sigma=sigma)
    # the operands as CudaBackend forms them: mask as fp32 and the explicit W
    inverse = CudaBackend()._inverse
    ones = torch.ones((m,), device=z.device)
    _, w_var = inverse(kern, z, ones > 0, t["lamn"] * ones)
    g_var = go.gram(xte, z, sigma)
    xs, zs, ms, rs, lamn = bless_t["k5"]
    mk5, wk5 = inverse(kern, zs, ms, rs)
    zb = bless_t["z"]
    mask = sweep_mask(n, folds, seed, x.device)
    vb = torch.randn((zb.shape[0], folds), generator=torch.Generator(device=x.device)
                     .manual_seed(seed), device=x.device)
    y_cv = y[:, None] * mask  # the sweep's right-hand sides: one column per fold
    slab = xte[:max(1, QUADFORM_SLAB_BYTES // (4 * m))]  # CudaBackend's variance slab
    tile = x[:KRR_CHUNK]  # one streamed / accumulated chunk of phase 12
    waves = [("knm_matvec@wave", xte[:KRR_MAX_WAVE]),
             ("knm_matvec@wave_half", xte[:KRR_MAX_WAVE // 2])]  # phase 12's buckets
    extra = [("knm_t@cv", n, zb.shape[0], d, folds, lambda: fo.knm_t(x, zb, y_cv, sigma),
              lambda: fo.knm_t_reference(x, zb, y_cv, sigma),
              lambda: _library_call("knm_t", x, zb, y_cv, s)),
             ("knm_matvec@cv", n, zb.shape[0], d, folds, lambda: fo.knm_matvec(x, zb, vb, sigma),
              lambda: fo.knm_matvec_reference(x, zb, vb, sigma),
              lambda: _library_call("knm_matvec", x, zb, vb, s)),
             ("gram@slab", slab.shape[0], m, d, m, lambda: go.gram(slab, z, sigma),
              lambda: go.gram_reference(slab, z, sigma),
              lambda: _library_call("gram", slab, z, None, s)),
             ("gram@stream", tile.shape[0], zb.shape[0], d, zb.shape[0],
              lambda: go.gram(tile, zb, sigma), lambda: go.gram_reference(tile, zb, sigma),
              lambda: _library_call("gram", tile, zb, None, s))]
    extra += [(name, xw.shape[0], m, d, 1, lambda xw=xw: fo.knm_matvec(xw, z, v, sigma),
               lambda xw=xw: fo.knm_matvec_reference(xw, z, v, sigma),
               lambda xw=xw: _library_call("knm_matvec", xw, z, v, s)) for name, xw in waves]
    if bless_t["k6_ladder"] is not None:
        xl, zl, ml, rl, _ = bless_t["k6_ladder"]
        mk6, wk6 = inverse(kern, zl, ml, rl)
        gl = go.gram(xl, zl, sigma) * mk6[None, :]
        extra.append(("quadform@ladder", xl.shape[0], zl.shape[0], d, 1,
                      lambda: qo.quadform(gl, wk6), lambda: qo.quadform_reference(gl, wk6),
                      lambda: _library_call("quadform", gl, None, None, s, w=wk6)))
    return [
        ("gram", m, m, d, m, lambda: go.gram(z, z, sigma),
         lambda: go.gram_reference(z, z, sigma), lambda: _library_call("gram", z, z, None, s)),
        ("falkon_matvec", n, m, d, 1, lambda: fo.falkon_matvec(x, z, v, sigma),
         lambda: fo.falkon_matvec_reference(x, z, v, sigma),
         lambda: _library_call("falkon_matvec", x, z, v, s)),
        ("falkon_matvec_masked", n, zb.shape[0], d, folds,
         lambda: fo.falkon_matvec(x, zb, vb, sigma, mask=mask),
         lambda: fo.falkon_matvec_masked_reference(x, zb, vb, mask, sigma),
         lambda: _library_call("falkon_matvec_masked", x, zb, vb, s, mask=mask)),
        ("knm_t", n, m, d, 1, lambda: fo.knm_t(x, z, y, sigma),
         lambda: fo.knm_t_reference(x, z, y, sigma),
         lambda: _library_call("knm_t", x, z, y, s)),
        ("knm_matvec", xte.shape[0], m, d, 1, lambda: fo.knm_matvec(xte, z, v, sigma),
         lambda: fo.knm_matvec_reference(xte, z, v, sigma),
         lambda: _library_call("knm_matvec", xte, z, v, s)),
        ("rls_score", xs.shape[0], zs.shape[0], d, 1,
         lambda: ro.rls_score(xs, zs, wk5, mk5, lamn, sigma),
         lambda: ro.rls_score_reference(xs, zs, wk5, mk5, lamn, sigma),
         lambda: _library_call("rls_score", xs, zs, None, s, w=wk5, mask=mk5, lamn=lamn)),
        ("quadform", xte.shape[0], m, d, 1, lambda: qo.quadform(g_var, w_var),
         lambda: qo.quadform_reference(g_var, w_var),
         lambda: _library_call("quadform", g_var, None, None, s, w=w_var)),
    ] + extra


def main_path_parity(calls) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    errs = {}
    bad = []
    for name, n, m, d, k, kern, plain, _ in calls:
        out, ref = kern(), plain()
        if name == "rls_score":
            err, ratio = _score_err(out, ref)
            ok = ratio <= 1.0
            log(f"parity@main {name} (n={n}, M={m}, d={d}): max_abs_err={err:.3e} "
                f"max err/(atol+rtol|ref|)={ratio:.3f}")
        else:
            err, scale = _err(out, ref)
            tol = GRAM_TOL if name.startswith("gram") else KNM_TOL * scale
            ok = err <= tol
            log(f"parity@main {name} (n={n}, M={m}, d={d}): max_abs_err={err:.3e} tol={tol:.3e}")
        errs[name] = err
        if not ok:
            bad.append(f"{name}: {err:.3e} out of tolerance")
        del out, ref
    if bad:
        raise PhaseError("main-path parity failed: " + "; ".join(bad))
    return errs


def kernel_times(calls, *, repeats: int = 5, plain_repeats: int = 2) -> dict:
    """CUDA-event times of each kernel, its plain version and the yardstick;
    K2's and K7's rows name the route ``matvec_plan`` gave them, K3's that of
    ``knm_t_plan``, K4's that of ``knm_matvec_plan`` and K1's that of
    ``gram_plan``."""
    from repro_torch.kernels import falkon_matvec_ops as fo
    from repro_torch.kernels import gram_ops as go

    times = {}
    for name, n, m, d, k, kern, plain, library in calls:
        b_ms, b_by = bound(name.split("@")[0], n, m, d, k)
        times[name] = {"ms": _cuda_ms(kern, repeats), "plain_ms": _cuda_ms(plain, plain_repeats),
                       "library_ms": _cuda_ms(library, plain_repeats),
                       "bound_ms": b_ms, "bound_by": b_by, "shape": [n, m, d, k]}
        if name.startswith("quadform"):
            times[name]["design"] = "register-tiled fp32"
        elif name == "rls_score":
            times[name]["design"] = ("on-chip Gram slab for two W column tiles, G W in 8x4 "
                                     "register tiles, depth split over two warp groups")
        elif name.startswith("gram"):
            plan = go.gram_plan(n, m, d)
            times[name]["route"] = plan.route
            times[name]["design"] = (
                f"{plan.rows}-row stripes walking runs of {plan.run} {plan.cols}-column tiles, "
                + ("16-byte" if plan.route == "wide" else "4-byte") + " streaming stores"
                if plan.route != "tiled" else "shared 64x64 gram_tile")
        elif name.startswith("knm_matvec"):
            plan = fo.knm_matvec_plan(n, m, d, k)
            times[name]["route"] = plan.route
            times[name]["design"] = (
                f"K3's register kernel on (z, x): G in registers, {plan.slice_rows}-row slices, "
                f"{plan.n_chunks} center chunks"
                if plan.route == "register" else "shared 64x64 gram_tile")
        elif name.startswith("knm_t"):
            plan = fo.knm_t_plan(n, m, d, k)
            times[name]["route"] = plan.route
            times[name]["design"] = (
                f"G in registers, {plan.slice_cols}-center slices, {plan.n_chunks} row chunks"
                if plan.route == "register" else "shared 64x64 gram_tile")
        elif name.startswith("falkon_matvec"):
            plan = fo.matvec_plan(n, m, d, k)
            times[name]["route"] = plan.route
            times[name]["design"] = (
                f"one Gram build per call, {plan.cluster}-block cluster, T through DSMEM"
                if plan.route == "cluster" else "two Gram builds per call (K4 then K3)")
        log(f"times {name}: {json.dumps(times[name])}")
    return times


def crossovers(device, times: dict, *, sigma: float = 4.0, seed: int = 0, d: int = 18,
               above_cap: tuple[int, int] = (1_000_000, 16_384)) -> dict:
    """Two times beside phase 6's, logged and not gated: K5 against K1 + K6 at
    M = MAX_FUSED_M on K5's main-path rows (where CudaBackend switches from
    the one to the other), and K2 on the two-stage route at an M above the
    cluster route's cap (its first stage K4 by ``knm_matvec_plan``, its
    second K3 by ``knm_t_plan``)."""
    from repro_torch.kernels import falkon_matvec_ops as fo
    from repro_torch.kernels import gram_ops as go
    from repro_torch.kernels import quadform_ops as qo
    from repro_torch.kernels import rls_score_ops as ro

    r = times["rls_score"]["shape"][0]
    mm = ro.MAX_FUSED_M
    x, z, w, mask, lamn = score_inputs(device, r, mm, d, "gaussian", sigma, seed + 1)
    out = {"k5_vs_k1_k6": {"shape": [r, mm, d],
                           "k5_ms": _cuda_ms(lambda: ro.rls_score(x, z, w, mask, lamn, sigma), 5),
                           "k1_k6_ms": _cuda_ms(lambda: qo.quadform(
                               go.gram(x, z, sigma) * mask[None, :], w), 5)}}
    del x, z, w, mask
    n, m = above_cap
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, d), generator=g, device=device)
    z = torch.randn((m, d), generator=g, device=device)
    v = torch.randn((m,), generator=g, device=device)
    plan = fo.matvec_plan(n, m, d, 1)
    b_ms, b_by = bound("falkon_matvec", n, m, d, 1)
    stage1 = fo.knm_matvec_plan(n, m, d, 1)
    out["falkon_matvec_above_cap"] = {"shape": [n, m, d, 1], "route": plan.route,
                                      "stage1_route": stage1.route,
                                      "stage1_center_chunks": stage1.n_chunks,
                                      "stage2_route": fo.knm_t_plan(n, m, d, 1).route,
                                      "ms": _cuda_ms(lambda: fo.falkon_matvec(x, z, v, sigma), 2),
                                      "bound_ms": b_ms, "bound_by": b_by}
    del x, z, v
    for key, row in out.items():
        log(f"times {key}: {json.dumps(row)}")
    return out


# ---------------------------------------------------------------------------
# 7. exact k-fold CV
# ---------------------------------------------------------------------------


def cross_validation(device, t: dict, center_set, *, folds: int = 5,
                     lams=(1e-5, 1e-6, 1e-7), iters: int = 20, sigma: float = 4.0,
                     seed: int = 0, exact_rows: int = 65_536, exact_m: int = 2_048) -> dict:
    """KFoldSweep through the front door on phase 4's data and the given
    (phase 5's) center set, with the launch counts reset just before the
    sweep and read just after; then the repeat gate, one naive refit's time,
    the exactness gate on the first ``exact_rows`` rows and the mask tax."""
    from repro_torch import kernels
    from repro_torch.api import KFoldSweep, UniformSampler
    from repro_torch.core import CudaBackend, falkon_fit, make_kernel
    from repro_torch.kernels import falkon_matvec_ops as fo

    xtr, ytr = t["x"], t["y"]
    n = xtr.shape[0]
    on_card = torch.device(device).type == "cuda"
    kern = make_kernel("gaussian", sigma=sigma)
    sweep = KFoldSweep(kernel=kern, lams=lams, folds=folds, iters=iters, seed=seed,
                       device=str(device))
    sync(device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = sweep.run(xtr, ytr, center_set=center_set)
    sync(device)
    sweep_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    again = sweep.run(xtr, ytr, center_set=center_set)
    repeat_equal = (torch.equal(res.fold_id, again.fold_id)
                    and torch.equal(res.scores, again.scores))
    for li, lam in enumerate(res.lams):
        log(f"cv lam={lam:g}: fold scores {json.dumps(res.scores[li].tolist())}, "
            f"mean {float(res.mean_scores[li]):.6f}")

    # one naive refit at full n: fold 0's training rows, the first lam
    m = int(center_set.count)
    dev = xtr.device
    z, a_diag = xtr[center_set.idx[:m].to(dev)], center_set.weight[:m].to(dev)
    train = res.fold_id != 0
    xf, yf = xtr[train], ytr[train]
    sync(device)
    t0 = time.perf_counter()
    falkon_fit(kern, xf, yf, z, lams[0], a_diag=a_diag, iters=iters, backend=CudaBackend())
    sync(device)
    naive_s = time.perf_counter() - t0
    del xf, yf

    # 60 iterations: both solves reach a squared-residual reduction near fp32
    # noise (on the CPU at this size 20 and 40 iterations agree to 1.1e-6 alike)
    exact = exact_cv(device, xtr[:exact_rows], ytr[:exact_rows], kern,
                     UniformSampler(m=exact_m).sample(seed, xtr[:exact_rows], kern),
                     lam=1e-3, folds=4, iters=60, seed=seed)

    # the mask tax: K7 against K2 at the sweep's shape, timed in turns
    tax = None
    if on_card:
        mask = sweep_mask(n, folds, seed, dev)
        v = torch.randn((m, folds), generator=torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
        k2, k7 = [], []
        for fn, into in ((lambda: fo.falkon_matvec(xtr, z, v, sigma), k2),
                         (lambda: fo.falkon_matvec(xtr, z, v, sigma, mask=mask), k7),
                         (lambda: fo.falkon_matvec(xtr, z, v, sigma, mask=mask), k7),
                         (lambda: fo.falkon_matvec(xtr, z, v, sigma), k2)):
            into.append(_cuda_ms(fn, 3))
        tax = {"k2_ms": k2, "k7_ms": k7, "ratio": sum(k7) / sum(k2), "shape": [n, m, folds]}
        log(f"mask tax (K7 / K2, turns K2 K7 K7 K2): {json.dumps(tax)}")

    out = {"n": n, "m": m, "folds": folds, "lams": list(res.lams), "iters": iters,
           "scores": res.scores.tolist(), "best_lam": res.best_lam, "sweep_s": sweep_s,
           "naive_refit_s": naive_s, "naive_grid_estimate_s": folds * len(lams) * naive_s,
           "launches": launches, "repeat_bit_identical": repeat_equal, "exact": exact,
           "mask_tax": tax}
    log(f"cv: {json.dumps({k: v for k, v in out.items() if k != 'scores'})}")
    bad = []
    if not bool(torch.all(torch.isfinite(res.scores))) or res.scores.shape != (len(lams), folds):
        bad.append(f"scores: shape {tuple(res.scores.shape)}, finite "
                   f"{bool(torch.all(torch.isfinite(res.scores)))}")
    if not repeat_equal:
        bad.append("a second sweep with the same seed gave other fold ids or scores")
    if not exact["max_rel_err"] <= CV_RTOL:
        bad.append(f"fold scores differ from naive refits by {exact['max_rel_err']:.3e} relative "
                   f"> {CV_RTOL}")
    if on_card:
        missing = [name for name in CV_PATH if launches[name] == 0]
        if missing:
            bad.append(f"kernels not launched on the CV path: {missing}")
        if not tax["ratio"] <= MASK_TAX_BOUND:
            bad.append(f"mask tax K7 / K2 = {tax['ratio']:.3f} > {MASK_TAX_BOUND}")
    if bad:
        raise PhaseError("cv failed: " + "; ".join(bad))
    return out


def exact_cv(device, x, y, kern, center_set, *, lam: float, folds: int, iters: int,
             seed: int) -> dict:
    """A ``folds``-fold sweep at one lam against a naive CudaBackend refit on
    each fold's training rows, same centers: max relative score difference.
    The sweep's solve is run once more as ``falkon_fit(row_mask=)`` on the
    sweep's own backend (the device's) to read its residual reduction (and
    to check that it gives the sweep's scores)."""
    from repro_torch.api import KFoldSweep
    from repro_torch.core import CudaBackend, falkon_fit
    from repro_torch.core.backend import backend_for_device

    res = KFoldSweep(kernel=kern, lams=(lam,), folds=folds, iters=iters, seed=seed,
                     device=str(device)).run(x, y, center_set=center_set)
    m = int(center_set.count)
    z = x[center_set.idx[:m].to(x.device)]
    a_diag = center_set.weight[:m].to(x.device)
    held = res.fold_id[:, None] == torch.arange(folds, device=x.device)[None, :]
    train = (~held).float()
    panel = falkon_fit(kern, x, y[:, None] * train, z, lam, a_diag=a_diag, iters=iters,
                       backend=backend_for_device(x.device), row_mask=train)
    sq = (panel.predict(x) - y[:, None]) ** 2
    replay = torch.sum(sq * held, dim=0) / torch.sum(held, dim=0)
    naive, naive_red = [], []
    for f in range(folds):
        rows = ~held[:, f]
        model = falkon_fit(kern, x[rows], y[rows], z, lam, a_diag=a_diag, iters=iters,
                           backend=CudaBackend())
        naive.append(float(torch.mean((model.predict(x[~rows]) - y[~rows]) ** 2)))
        naive_red.append(float(model.diagnostics.reduction.max()))
    scores = res.scores[0].tolist()
    rel = [abs(a - b) / abs(b) for a, b in zip(scores, naive)]
    out = {"rows": x.shape[0], "m": m, "lam": lam, "folds": folds, "iters": iters,
           "sweep_scores": scores, "naive_scores": naive, "max_rel_err": max(rel),
           "sweep_residual_reduction": panel.diagnostics.reduction.tolist(),
           "naive_residual_reduction": naive_red,
           "replay_equals_sweep": bool(torch.equal(replay, res.scores[0]))}
    log(f"cv exactness: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# 8. the classifier
# ---------------------------------------------------------------------------


def classify(device, t: dict, center_set, bless_test_error: float, *, lam: float = 1e-6,
             iters: int = 20, sigma: float = 4.0, seed: int = 0) -> dict:
    """FalkonClassifier through the front door on phase 4's data and the given
    center set, counts reset just before the fit and read after the test
    predictions; its accuracy against 1 - the FALKON-BLESS regressor's test
    error on the same centers, lam and iterations."""
    from repro_torch import kernels
    from repro_torch.api import FalkonClassifier, FitConfig

    xtr, ytr, xte, yte = t["x"], t["y"], t["xte"], t["yte"]
    clf = FalkonClassifier(kernel="gaussian", sigma=sigma,
                           config=FitConfig(lam=lam, iters=iters, seed=seed, device=str(device)))
    sync(device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    clf.fit(xtr, ytr, center_set=center_set)
    sync(device)
    fit_s = time.perf_counter() - t0
    margins = clf.decision_function(xte)
    accuracy = clf.score(xte, yte)
    sync(device)
    launches = kernels.launch_counts()
    scale = float(margins.abs().max())
    antisym = float((margins[:, 0] + margins[:, 1]).abs().max()) / scale
    res = {"n_train": xtr.shape[0], "classes": clf.classes_.tolist(),
           "m": int(center_set.count), "lam": lam, "iters": iters, "fit_s": fit_s,
           "accuracy": accuracy, "one_minus_bless_error": 1.0 - bless_test_error,
           "margin_sum_over_max": antisym,
           "cg_residual_reduction": clf.model_.diagnostics.reduction.tolist(),
           "launches": launches}
    log(f"classifier: {json.dumps(res)}")
    bad = []
    if tuple(margins.shape) != (xte.shape[0], 2) or not math.isfinite(scale):
        bad.append(f"margins: shape {tuple(margins.shape)}, max|margin| {scale}")
    if not abs(accuracy - (1.0 - bless_test_error)) <= E2E_TOL:
        bad.append(f"accuracy {accuracy:.5f} is not within {E2E_TOL} of 1 - the FALKON-BLESS "
                   f"test error ({1.0 - bless_test_error:.5f})")
    if not antisym <= 1e-5:
        bad.append(f"the two margin columns are not negatives of each other: {antisym:.3e}")
    if torch.device(device).type == "cuda":
        missing = [name for name in CLASSIFIER_PATH if launches[name] == 0]
        if missing:
            bad.append(f"kernels not launched on the classifier path: {missing}")
    if bad:
        raise PhaseError("classifier failed: " + "; ".join(bad))
    return res


# ---------------------------------------------------------------------------
# 12. KRR serving, out-of-core streaming, durable and online FALKON
# ---------------------------------------------------------------------------

#: the kernels phase 12 must launch: K4 in every serving wave, K1 in every
#: streamed tile, accumulator chunk and K_MM.
KRR_ONLINE_PATH = ("gram", "knm_matvec")
#: phase 12's streamed chunk (rows) and largest serving wave (rows); phase 6
#: times K1 and K4 at these shapes.
KRR_CHUNK = 65_536
KRR_MAX_WAVE = 4096
#: the durable and online fits' distance from the fp64 referee, over max
#: |fp64 pred|: fp64 accumulators of K1's fp32 G read 9.1e-6 and 8.2e-6 at
#: SUSY scale on the H100, against 4.1e-3 for the fp32 K2 fit.
FP64_ACC_TOL = 1e-4
#: (statuses, stats) of the backend.error isolation script below, the
#: reference's ``test_dispatch_error_wave_isolated`` (tests/test_chaos.py):
#: two 8-row requests in one 16-row wave; the wave's dispatch raises once,
#: each half is retried alone and served.
BACKEND_ERROR_EXPECTED = (
    ["done", "done"],
    {"requests": 2, "rows": 16, "dispatches": 3, "padded_rows": 16, "buckets": [16],
     "wave_failures": 1, "splits": 1, "shed": 0, "expired": 0, "failed": 0,
     "degraded_waves": 0, "swaps": 0, "swaps_rejected": 0, "model_version": 0,
     "last_swap": None})


def backend_error_script(server_cls, config_cls, faults, model, requests):
    """The isolation script: ``requests`` (host arrays) submitted to a fresh
    ``server_cls(model, config=config_cls(min_bucket=16))``, served with
    ``backend.error`` armed for one firing. Returns (statuses, stats with
    the bucket set as a sorted list). The classes and the ``faults`` module
    are arguments, so the same script runs on either package."""
    srv = server_cls(model, config=config_cls(min_bucket=16))
    rids = [srv.submit(q) for q in requests]
    with faults.fault("backend.error", times=1):
        srv.run_until_idle()
    stats = dict(srv.stats)
    stats["buckets"] = sorted(stats["buckets"])
    return [srv.status(r).value for r in rids], stats


def serving_traffic(xte_host: torch.Tensor, requests: int, max_rows: int,
                    seed: int) -> list[torch.Tensor]:
    """``requests`` host requests of 1..``max_rows`` rows (sizes from
    ``seed``), consecutive slices of the test set, wrapping around."""
    g = torch.Generator().manual_seed(seed)
    sizes = torch.randint(1, max_rows + 1, (requests,), generator=g).tolist()
    out, off = [], 0
    for r in sizes:
        if off + r > xte_host.shape[0]:
            off = 0
        out.append(xte_host[off:off + r])
        off += r
    return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a - b| / max|b| (inf when a is not finite)."""
    if not bool(torch.all(torch.isfinite(a))):
        return math.inf
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def fp64_referee(kern, x, y, z, a_diag, lam: float, iters: int, xte) -> torch.Tensor:
    """Predictions on ``xte`` of a TorchBackend fit on fp64 copies of the same
    rows, centers, weights, lam and iterations: phase 12's referee. The fp32
    fits at this lam lie ~4e-3 of max|pred| from it, while fp64 sums of the
    same fp32 Gram values lie ~1e-5 from it, so the fp32 fits are held to it
    relative to the K2 fit, as phase 4's refits are."""
    from repro_torch.core import TorchBackend, falkon_fit

    be = TorchBackend()
    model = falkon_fit(kern, x.double(), y.double(), z.double(), lam, a_diag=a_diag.double(),
                       iters=iters, backend=be, fused=False)
    return model.predict(xte.double(), backend=be)


def krr_online(device, t: dict, bless_t: dict, *, sigma: float = 4.0, lam: float = 1e-6,
               iters: int = 20, requests: int = 4096, max_rows: int = 64,
               max_wave: int = KRR_MAX_WAVE, min_bucket: int = 64, chunk: int = KRR_CHUNK,
               ckpt_every: int = 4, online_rows: int = 900_000, appends: int = 10,
               append_rows: int = 10_000, seed: int = 0, max_error: float = 0.2) -> dict:
    """Phase 12 on phase 4's data and model and phase 5's BLESS centers,
    weights and fit, with the launch counts reset just before the phase's
    work and read just after (the direct predictions the gates compare with
    are made before the reset):

      (a) ``KrrServer`` on phase 4's uniform model: ``requests`` requests of
          1..``max_rows`` test rows, one flush; each request's rows against
          ``model.predict`` of the same rows, 1e-4 * max|pred|.
      (b) ``AsyncKrrServer(ServeConfig(max_inflight=2))`` on the same
          traffic: equal to (a) to 1e-4 * max|pred|; then under one
          ``gram.nan_tile`` firing every request DONE with one wave failure
          and a split; then the backend.error isolation script, whose
          statuses and stats must be ``BACKEND_ERROR_EXPECTED``.
      (c) ``falkon_fit`` on ``ChunkStore(x, y, chunk=chunk)`` (pinned host
          memory on the card) through ``"stream:cuda"``: predictions within
          1e-3 * max|pred| of phase 5's fit on the device-resident data
          through ``CudaBackend`` (same centers, weights, lam and
          iterations), and the allocator's peak above what was resident
          before the fit < 0.25 * 4 n M.
      (d) ``resumable_streamed_fit`` on the same store and centers,
          ``ckpt_every`` chunks per barrier: uninterrupted, then killed by
          ``ckpt.torn_write`` at ``pre_rename`` on its third barrier and
          resumed; the resumed alpha equals the uninterrupted one bit for
          bit, and the test error is below ``max_error``.
      (e) ``OnlineFalkon`` on the first ``online_rows`` rows, ``appends``
          appends of ``append_rows`` rows, a warm refit after each: final
          predictions within 1e-2 relative of (d)'s; a NaN row armed with
          ``online.corrupt_row`` is rejected with the store, H and b
          untouched (``torch.equal``) and the caller's batch unwritten.

    The referee of (c)-(e) is ``fp64_referee`` (each distance a max abs
    difference over max |fp64 prediction|): the streamed fit no farther from
    it than phase 5's K2 fit is, plus E2E_TOL; the durable and online fits,
    whose accumulators and solve are fp64, within FP64_ACC_TOL.
    Each step's launches are recorded beside its times.
    """
    import tempfile

    from repro_torch import kernels
    from repro_torch.api import (AsyncKrrServer, ChunkStore, KrrServer, OnlineFalkon,
                                 ServeConfig, resumable_streamed_fit)
    from repro_torch.checkpoint import latest_step
    from repro_torch.core import FalkonModel, falkon_fit, health, make_kernel
    from repro_torch.core.backend import backend_for_device
    from repro_torch.serving import RequestStatus
    from repro_torch.stream import device_memory_stats
    from repro_torch.testing import faults

    on_card = torch.device(device).type == "cuda"
    xtr, ytr, xte, yte = t["x"], t["y"], t["xte"], t["yte"]
    n = xtr.shape[0]
    kern = make_kernel("gaussian", sigma=sigma)
    be = backend_for_device(device)
    model = FalkonModel(centers=t["z"], alpha=t["alpha"], kernel=kern, backend=be)
    zb, ab = bless_t["z"], bless_t["a_diag"]
    m = zb.shape[0]
    bless_model = FalkonModel(centers=zb, alpha=bless_t["alpha"], kernel=kern, backend=be)
    traffic = serving_traffic(xte.cpu(), requests, max_rows, seed)
    direct = model.predict(torch.cat(traffic).to(xte.device))
    direct_parts = torch.split(direct, [q.shape[0] for q in traffic])
    scale = float(direct.abs().max())
    ref_pred = bless_model.predict(xte)
    ref64 = fp64_referee(kern, xtr, ytr, zb, ab, lam, iters, xte)
    scale64 = float(ref64.abs().max())

    def to_referee(pred: torch.Tensor) -> float:
        """max |pred - the fp64 referee's| / max |the referee's| (inf if not finite)."""
        if not bool(torch.all(torch.isfinite(pred))):
            return math.inf
        return float((pred.double() - ref64).abs().max()) / scale64

    res = {"n_train": n, "m_uniform": t["z"].shape[0], "m": m, "requests": requests,
           "rows": int(direct.shape[0]), "chunk": chunk}
    bad = []
    seen = dict.fromkeys(KRR_ONLINE_PATH, 0)

    def step_launches() -> dict:
        """The path's launches since the previous call (counts since the reset)."""
        now = kernels.launch_counts()
        out = {name: now[name] - seen[name] for name in KRR_ONLINE_PATH}
        seen.update({name: now[name] for name in KRR_ONLINE_PATH})
        return out

    sync(device)
    kernels.reset_launch_counts()
    # (a) KrrServer
    srv = KrrServer(model, max_wave=max_wave, min_bucket=min_bucket)
    t0 = time.perf_counter()
    rids = [srv.submit(q) for q in traffic]
    out = srv.flush()
    sync(device)
    serve_s = time.perf_counter() - t0
    err_a = max(float((out[r] - d).abs().max()) for r, d in zip(rids, direct_parts)) / scale
    res["serve"] = {"seconds": serve_s, "requests_per_s": requests / serve_s,
                    "rows_per_s": int(direct.shape[0]) / serve_s,
                    "dispatches": srv.stats["dispatches"], "padded_rows": srv.stats["padded_rows"],
                    "buckets": sorted(srv.stats["buckets"]), "err_over_max": err_a,
                    "launches": step_launches()}
    if not err_a <= KNM_TOL:
        bad.append(f"(a) KrrServer rows {err_a:.3e} of max|pred| from model.predict")

    # (b) AsyncKrrServer: the same traffic, then a NaN tile, then backend.error
    asrv = AsyncKrrServer(model, config=ServeConfig(max_wave=max_wave, min_bucket=min_bucket,
                                                    max_inflight=2))
    t0 = time.perf_counter()
    arids = [asrv.submit(q) for q in traffic]
    asrv.run_until_idle()
    sync(device)
    async_s = time.perf_counter() - t0
    done = all(asrv.status(r) == RequestStatus.DONE for r in arids)
    err_b = (max(float((asrv.result(a) - out[r]).abs().max()) for a, r in zip(arids, rids))
             / scale if done else math.inf)
    nsrv = AsyncKrrServer(model, config=ServeConfig(max_wave=max_wave, min_bucket=min_bucket,
                                                    max_inflight=2))
    nrids = [nsrv.submit(q) for q in traffic]
    with faults.fault("gram.nan_tile", times=1):
        nsrv.run_until_idle()
    nan_done = all(nsrv.status(r) == RequestStatus.DONE for r in nrids)
    g = torch.Generator().manual_seed(seed)
    script = backend_error_script(AsyncKrrServer, ServeConfig, faults, model,
                                  [torch.randn((8, xte.shape[1]), generator=g) for _ in range(2)])
    res["async"] = {"seconds": async_s, "requests_per_s": requests / async_s,
                    "dispatches": asrv.stats["dispatches"], "p99_wave_s": asrv.p99_latency(),
                    "err_over_max": err_b, "nan_tile": {
                        "all_done": nan_done, "wave_failures": nsrv.stats["wave_failures"],
                        "splits": nsrv.stats["splits"]},
                    "backend_error_script": {"statuses": script[0], "stats": script[1]},
                    "launches": step_launches()}
    if not err_b <= KNM_TOL:
        bad.append(f"(b) AsyncKrrServer results {err_b:.3e} of max|pred| from (a)'s")
    if not (nan_done and nsrv.stats["wave_failures"] == 1 and nsrv.stats["splits"] >= 1):
        bad.append(f"(b) nan_tile isolation: {res['async']['nan_tile']}")
    if list(script) != list(BACKEND_ERROR_EXPECTED):
        bad.append(f"(b) backend.error script gave {script}, not {BACKEND_ERROR_EXPECTED}")

    # (c) the streamed fit from pinned host memory
    store = ChunkStore(xtr, ytr, chunk=chunk, device=device)
    sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        base = device_memory_stats(device)["allocated_bytes.all.current"]
    t0 = time.perf_counter()
    smodel = falkon_fit(kern, store, ytr, zb, lam, a_diag=ab, iters=iters, backend="stream:cuda")
    sync(device)
    stream_s = time.perf_counter() - t0
    peak = device_memory_stats(device)["allocated_bytes.all.peak"] - base if on_card else None
    launches_c = step_launches()
    spred = smodel.predict(xte)
    err_c = _rel(spred, ref_pred)
    res["referee"] = {"rows": n, "max_abs_pred_fp64": scale64, "k2_fit": to_referee(ref_pred),
                      "stream": to_referee(spred)}
    res["stream"] = {"fit_s": stream_s, "n_chunks": store.n_chunks,
                     "test_error": float(torch.mean((torch.sign(spred) != yte).float())),
                     "err_over_max_vs_cuda_fit": err_c, "peak_bytes_above_base": peak,
                     "knm_bytes": 4 * n * m,
                     "cg_residual_reduction": float(smodel.diagnostics.reduction.max()),
                     "launches": launches_c}
    if not err_c <= E2E_TOL:
        bad.append(f"(c) streamed fit {err_c:.3e} of max|pred| from the CudaBackend fit")
    if peak is not None and not peak < 0.25 * 4 * n * m:
        bad.append(f"(c) allocator peak {peak} B above base is not < 0.25 * 4 n M")

    # (d) the durable fit: uninterrupted, then killed at the third barrier and resumed
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(centers=zb, lam=lam, a_diag=ab, iters=iters, backend="stream:cuda",
                  ckpt_every=ckpt_every, key=torch.Generator().manual_seed(seed))
        t0 = time.perf_counter()
        dmodel = resumable_streamed_fit(kern, store, ckpt_dir=f"{tmp}/whole", **kw)
        sync(device)
        durable_s = time.perf_counter() - t0
        killed = False
        t0 = time.perf_counter()
        with faults.fault("ckpt.torn_write", stage="pre_rename", skip=2, times=1):
            try:
                resumable_streamed_fit(kern, store, ckpt_dir=f"{tmp}/killed", **kw)
            except faults.FaultInjected:
                killed = True
        sync(device)
        killed_s = time.perf_counter() - t0
        resumed_from = latest_step(f"{tmp}/killed")
        t0 = time.perf_counter()
        rmodel = resumable_streamed_fit(kern, store, ckpt_dir=f"{tmp}/killed", **kw)
        sync(device)
        resume_s = time.perf_counter() - t0
    launches_d = step_launches()
    dpred = dmodel.predict(xte)
    bitwise = torch.equal(rmodel.alpha, dmodel.alpha)
    res["durable"] = {"fit_s": durable_s, "killed_s": killed_s, "resume_s": resume_s,
                      "killed": killed, "resumed_from_step": resumed_from,
                      "bit_identical": bitwise,
                      "cg_residual_reduction": float(dmodel.diagnostics.reduction.max()),
                      "test_error": float(torch.mean((torch.sign(dpred) != yte).float())),
                      "err_over_max_vs_cuda_fit": _rel(dpred, ref_pred),
                      "launches": launches_d}
    res["referee"]["durable"] = to_referee(dpred)
    if not (killed and resumed_from == 2 * ckpt_every):
        bad.append(f"(d) the torn write did not kill the fit at its third barrier "
                   f"(killed {killed}, latest step {resumed_from})")
    if not bitwise:
        bad.append("(d) the resumed alpha differs from the uninterrupted alpha")
    if not res["durable"]["test_error"] < max_error:
        bad.append(f"(d) durable test error {res['durable']['test_error']:.4f} >= {max_error}")

    # (e) online: seed batch, appends with warm refits, the NaN fence
    t0 = time.perf_counter()
    online = OnlineFalkon(kern, zb, lam, x=ChunkStore(xtr[:online_rows], ytr[:online_rows],
                                                      chunk=chunk, device=device),
                          a_diag=ab, iters=iters, backend="stream:cuda")
    sync(device)
    seed_s = time.perf_counter() - t0
    refit_ms, append_ms = [], []
    for i in range(appends):
        lo = online_rows + i * append_rows
        t0 = time.perf_counter()
        online.append(xtr[lo:lo + append_rows], ytr[lo:lo + append_rows])
        sync(device)
        append_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        omodel = online.refit()
        sync(device)
        refit_ms.append(1e3 * (time.perf_counter() - t0))
    launches_e = step_launches()
    opred = omodel.predict(xte)
    err_e = _rel(opred, dpred)
    res["referee"]["online"] = to_referee(opred)
    h0, b0, x0, n0 = online._h.clone(), online._b.clone(), online.store.x.clone(), len(online.store)
    batch = xtr[:100].clone()
    rejected = False
    with faults.fault("online.corrupt_row", row=3):
        try:
            online.append(batch, ytr[:100])
        except health.NonFiniteError:
            rejected = True
    untouched = (len(online.store) == n0 and torch.equal(online.store.x, x0)
                 and torch.equal(online._h, h0) and torch.equal(online._b, b0)
                 and torch.equal(batch, xtr[:100]))
    res["online"] = {"seed_rows": online_rows, "seed_s": seed_s, "appends": appends,
                     "append_rows": append_rows, "append_ms": append_ms, "refit_ms": refit_ms,
                     "rows": online.counters["rows"], "err_over_max_vs_durable": err_e,
                     "cg_residual_reduction": float(omodel.diagnostics.reduction.max()),
                     "nan_rejected": rejected, "nan_state_untouched": untouched,
                     "launches": launches_e}
    if not err_e <= 1e-2:
        bad.append(f"(e) online predictions {err_e:.3e} of max|pred| from the durable fit's")
    if not (rejected and untouched):
        bad.append(f"(e) NaN fence: rejected {rejected}, state untouched {untouched}")
    if not res["referee"]["stream"] <= res["referee"]["k2_fit"] + E2E_TOL:
        bad.append(f"(c) the streamed fit is {res['referee']['stream']:.3e} from the fp64 "
                   f"referee, farther than the K2 fit ({res['referee']['k2_fit']:.3e}) + {E2E_TOL}")
    for step in ("durable", "online"):
        if not res["referee"][step] <= FP64_ACC_TOL:
            bad.append(f"the {step} fit is {res['referee'][step]:.3e} from the fp64 referee "
                       f"> {FP64_ACC_TOL}")
    sync(device)
    launches = kernels.launch_counts()
    res["launches"] = launches
    log(f"krr_online: {json.dumps(res)}")
    if on_card:
        missing = [name for name in KRR_ONLINE_PATH if launches[name] == 0]
        if missing:
            bad.append(f"kernels not launched on the serving / streaming path: {missing}")
    if bad:
        raise PhaseError("krr-online failed: " + "; ".join(bad))
    res["referee_t"] = {"ref64": ref64, "scale64": scale64, "k2_fit": res["referee"]["k2_fit"]}
    return res


# ---------------------------------------------------------------------------
# ranks: every multi-rank phase (13 (b), 16 (b), 17 (b), 18, 19, 20 (b)) runs
# its ranks as processes placed by one rule
# ---------------------------------------------------------------------------


def cards_of(device) -> int:
    """The cards a phase on ``device`` may place ranks on: the machine's
    CUDA devices on a card, 1 on the CPU."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def rank_route(rank: int, world: int, device, cards: int) -> tuple[str, str]:
    """(device, process-group backend) of rank ``rank`` of ``world``: its
    own card ``cuda:<rank>`` over NCCL when ``device`` is a card and the
    machine has at least ``world`` cards; else the shared ``device`` over
    gloo (NCCL refuses two ranks on one card, and the CPU has no NCCL)."""
    if torch.device(device).type == "cuda" and cards >= world:
        return f"cuda:{rank}", "nccl"
    return str(device), "gloo"


def route_name(backend: str) -> str:
    """How a phase's log line names its ranks' route."""
    return "nccl per card" if backend == "nccl" else "gloo shared"


def rank_setup(rank: int, world: int, tmp: str, device: str, backend: str) -> bool:
    """The start of a rank's process: on a card, the rank's card made the
    current device and CUDA initialised on it (so a ``DeviceMesh`` keeps
    it), TF32 off and phase 2's build loaded; on the CPU one thread. Then
    the ``backend`` group on ``tmp``'s ``file://`` rendezvous, NCCL bound to
    the rank's card. Returns whether the rank is on a card."""
    import torch.distributed as dist

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        from repro_torch.kernels import build

        dev = torch.device("cuda", dev.index or 0)  # "cuda": the shared card
        torch.cuda.set_device(dev)
        torch.cuda.init()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.build()  # loads phase 2's build
    else:
        torch.set_num_threads(1)
    bind = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"file://{tmp}/rdv", rank=rank,
                            world_size=world, **bind)
    return on_card


def run_ranks(fn: str, world: int, tmp: str, device, args: tuple, *, phase: str,
              timeout: float, cards: int | None = None) -> tuple[list[dict], dict]:
    """``fn(rank, world, tmp, device, backend, *args)`` of this script in
    ``world`` processes, each placed by ``rank_route`` (``cards``: the
    machine's, by default), its output to ``tmp/rank<r>.log``; then each
    rank's ``tmp/rank<r>.pt``. The first rank to fail, or the time limit,
    ends the phase: every rank still running is killed with its process
    tree (under NCCL the others would wait on the dead rank's collectives
    for ever) and a PhaseError names the failed ranks with their output.
    Logs the route, the world and the wall time; returns (the ranks'
    results, {"route", "backend", "world", "wall_s"})."""
    cards = cards_of(device) if cards is None else cards
    routes = [rank_route(r, world, device, cards) for r in range(world)]
    backend = routes[0][1]
    t0 = time.perf_counter()
    procs, codes, late = [], [], False
    try:
        for r, (dev, be) in enumerate(routes):
            code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); import chip_smoke; "
                    f"chip_smoke.{fn}({r}, {world}, {tmp!r}, {dev!r}, {be!r}, *{tuple(args)!r})")
            with open(f"{tmp}/rank{r}.log", "w") as out:
                procs.append(subprocess.Popen([sys.executable, "-c", code], stdout=out,
                                              stderr=subprocess.STDOUT))
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes) or all(c == 0 for c in codes):
                break
            if time.perf_counter() - t0 > timeout:
                late = True
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                _kill_tree(p.pid)
            p.wait()
    wall_s = time.perf_counter() - t0
    info = {"route": route_name(backend), "backend": backend, "world": world, "wall_s": wall_s}
    log(f"{phase}: route={info['route']} world={world} wall={wall_s:.1f} s")
    failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
    running = [r for r, c in enumerate(codes) if c is None]  # killed here
    if failed or late:
        shown = failed or running
        tails = "".join(f"\nrank {r}:\n" + pathlib.Path(f"{tmp}/rank{r}.log").read_text()[-1500:]
                        for r in shown[:2])
        what = (f"ranks {failed} failed" if failed else
                f"the {world} ranks did not finish in {timeout} s (ranks {running} still running)")
        raise PhaseError(f"{phase}: {what} ({info['route']}; ranks {running} killed):{tails}")
    return [torch.load(f"{tmp}/rank{r}.pt") for r in range(world)], info


# ---------------------------------------------------------------------------
# 13. the rest of repro.core: sharded, guarded and fused fits
# ---------------------------------------------------------------------------

#: the kernels phase 13 must launch on the card: K1 (K_MM), K2 and K3 in the
#: sharded and guarded fits, K4 in their predictions.
CORE_REST_PATH = ("gram", "falkon_matvec", "knm_t", "knm_matvec")
#: phase 13's fused fits: the first on this many rows, the second on 1 000
#: fewer, both in one 8 192-row bucket (10^6 rows and 999 000 straddle a
#: bucket edge).
FUSED_ROWS = 999_000


def sharded_rank(rank: int, world: int, tmp: str, device: str, backend: str, sigma: float,
                 lam: float, iters: int) -> None:
    """One rank of phase 13 (b), in its own process (placed by
    ``rank_route``): the whole X from ``tmp/inputs.pt`` on ``device``, a
    ``ShardedBackend`` fit and its predictions (the local contractions are
    the kernels on the card); writes ``tmp/rank<r>.pt``."""
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.core import falkon_fit, make_kernel
    from repro_torch.core.backend import ShardedBackend, backend_for_device, default_backend

    on_card = rank_setup(rank, world, tmp, device, backend)
    try:
        inp = torch.load(f"{tmp}/inputs.pt")
        x, y, z, a, xte = (inp[k].to(device) for k in ("x", "y", "z", "a_diag", "xte"))
        kern = make_kernel("gaussian", sigma=sigma)
        picked = (default_backend(device, n=x.shape[0]) if on_card
                  else backend_for_device(device, n=x.shape[0]))
        sync(device)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        model = falkon_fit(kern, x, y, z, lam, a_diag=a, iters=iters, backend=ShardedBackend())
        sync(device)
        fit_s = time.perf_counter() - t0
        pred = model.predict(xte)
        sync(device)
        torch.save({"alpha": model.alpha.cpu(), "pred": pred.cpu(), "fit_s": fit_s,
                    "launches": kernels.launch_counts(), "picked": type(picked).__name__,
                    "collectives": ShardedBackend.collectives},
                   f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def core_rest(device, t: dict, bless_t: dict, referee: dict, bless_test_error: float, *,
              sigma: float = 4.0, lam: float = 1e-6, iters: int = 20, world: int = 2,
              fused_rows: int = FUSED_ROWS, lam2: float = 1e-5, sigma2: float = 5.0,
              fault_call: int = 5, timeout: float = 600.0) -> dict:
    """Phase 13 on phase 4's data and phase 5's BLESS centers, weights and
    fit, with the launch counts reset just before and read just after (the
    ranks of (b) add theirs):

      (a) ``falkon_fit(backend=ShardedBackend())`` in a one-rank group
          (NCCL on the card, gloo on the CPU, ``file://`` rendezvous): alpha
          equal bit for bit to the host-loop fit on the device's backend
          (on the card ``CudaBackend``, whose alpha must equal phase 5's),
          with the same K1, K2 and K3 launches.
      (b) ranks in their own processes (``run_ranks``): one a card over
          NCCL, as many as the machine's cards, when it has more than one;
          else ``world`` sharing the device over gloo. Each rank's alpha
          equal to the others' bit for bit;
          predictions no farther from phase 12's fp64 referee (``referee``:
          its predictions and the K2 fit's distance) than the K2 fit is,
          plus E2E_TOL; test error within 1e-3 of phase 5's; in the group
          the default pick for n rows is ``ShardedBackend`` (from
          ``SHARD_MIN_ROWS`` rows; the device's backend below).
      (c) ``GuardedBackend`` around the device's backend: on the happy path
          alpha equal bit for bit to (a)'s reference fit, the same launches,
          no ``backend_fallback`` event; around ``FaultyBackend`` armed to
          raise on the ``fault_call``-th quadratic-op call: one event (for
          ``knm_quadratic``). On the card the fit then raises the fault and
          the event names no fallback (the plain version never serves the
          card's tensors); on the CPU the fallback finishes the fit, whose
          predictions lie within E2E_TOL * max|pred| of the clean fit's.
      (d) on an emptied plan cache, ``falkon_fit(backend="torch")`` (so
          fused) on the first ``fused_rows`` rows, then ``fused_rows -
          1000`` rows at ``lam2`` and ``sigma2``: on the card one plan (one
          graph capture) for the first fit and none for the second; on the
          CPU, where the fused fit is the host loop, none. Each fit is
          refereed by an fp64 host-loop fit on the same rows, centers, lam
          and sigma (``fp64_referee``): its test predictions no farther from
          it than the fp32 host loop's (``fused=False``), plus E2E_TOL. The
          second fit, at the better conditioned ``lam2``, is also held to
          the host loop directly: predictions within E2E_TOL of max|pred|.
          At ``lam`` the fused-host distances are logged, not gated: both
          paths converge to fp32 noise, where operators that differ by
          ~1e-7 (the padded last block) part by 1.7e-2 of max|alpha| and
          1.6e-3 of max|pred| on the H100.
    """
    import tempfile
    import warnings

    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.core import falkon_fit, health, make_kernel
    from repro_torch.core import falkon as falkon_mod
    from repro_torch.core.backend import (SHARD_MIN_ROWS, GuardedBackend, ShardedBackend,
                                          TorchBackend, backend_for_device)
    from repro_torch.core.distributed import data_group, sum_ranks
    from repro_torch.testing import faults

    on_card = torch.device(device).type == "cuda"
    x, y, xte, yte = t["x"], t["y"], t["xte"], t["yte"]
    z, a = bless_t["z"], bless_t["a_diag"]
    kern = make_kernel("gaussian", sigma=sigma)
    be = backend_for_device(device)
    core_names = ("gram", "falkon_matvec", "knm_t")

    def fit(backend, **kw):
        """(model, seconds, launches) of one fit on phase 5's centers."""
        sync(device)
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        model = falkon_fit(kern, x, y, z, lam, a_diag=a, iters=iters, backend=backend, **kw)
        sync(device)
        after = kernels.launch_counts()
        return model, time.perf_counter() - t0, {n: after[n] - before[n] for n in core_names}

    def to_referee(pred: torch.Tensor) -> float:
        return float((pred.double() - referee["ref64"]).abs().max()) / referee["scale64"]

    bad = []
    res = {"n_train": x.shape[0], "m": z.shape[0], "lam": lam, "iters": iters}
    sync(device)
    kernels.reset_launch_counts()

    # (a) a one-rank group
    ref, ref_s, ref_launches = fit(be, fused=False)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl" if on_card else "gloo", init_method=f"file://{tmp}/rdv",
                                rank=0, world_size=1)
        try:
            sum_ranks(data_group(), torch.zeros(1, device=device))  # builds the communicator
            c0 = ShardedBackend.collectives
            sharded, sharded_s, sharded_launches = fit(ShardedBackend())
            collectives = ShardedBackend.collectives - c0
        finally:
            dist.destroy_process_group()
    res["a"] = {"fit_s": sharded_s, "reference_fit_s": ref_s, "collectives": collectives,
                "launches": sharded_launches, "reference_launches": ref_launches,
                "bit_identical": torch.equal(sharded.alpha, ref.alpha),
                "reference_equals_phase5": torch.equal(ref.alpha, bless_t["alpha"])}
    if not res["a"]["bit_identical"]:
        bad.append("(a) the one-rank sharded alpha differs from the device backend's")
    if on_card and not res["a"]["reference_equals_phase5"]:
        bad.append("(a) the CudaBackend refit's alpha differs from phase 5's")
    if sharded_launches != ref_launches:
        bad.append(f"(a) launches {sharded_launches} against the reference fit's {ref_launches}")

    # (b) ``world`` ranks, each its own process: one a card over NCCL where
    # the machine has the cards (as many ranks as cards), else sharing the
    # one device over gloo
    cards = cards_of(device)
    world = cards if cards > 1 else world
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"x": x.cpu(), "y": y.cpu(), "z": z.cpu(), "a_diag": a.cpu(),
                    "xte": xte.cpu()}, f"{tmp}/inputs.pt")
        ranks, run = run_ranks("sharded_rank", world, tmp, device, (sigma, lam, iters),
                               phase="core-rest (b)", timeout=timeout, cards=cards)
    pred_b = ranks[0]["pred"].to(device)
    res["b"] = {**run, "fit_s": [r["fit_s"] for r in ranks],
                "launches": [r["launches"] for r in ranks],
                "collectives": [r["collectives"] for r in ranks],
                "picked": [r["picked"] for r in ranks],
                "ranks_bit_identical": all(torch.equal(r["alpha"], ranks[0]["alpha"])
                                           and torch.equal(r["pred"], ranks[0]["pred"])
                                           for r in ranks),
                "referee": to_referee(pred_b), "k2_fit_referee": referee["k2_fit"],
                "test_error": float(torch.mean((torch.sign(pred_b) != yte).float())),
                "bless_test_error": bless_test_error}
    if not res["b"]["ranks_bit_identical"]:
        bad.append("(b) the ranks' alpha or predictions differ")
    if not res["b"]["referee"] <= referee["k2_fit"] + E2E_TOL:
        bad.append(f"(b) the {world}-rank fit is {res['b']['referee']:.3e} from the fp64 referee, "
                   f"farther than the K2 fit ({referee['k2_fit']:.3e}) + {E2E_TOL}")
    if not abs(res["b"]["test_error"] - bless_test_error) <= 1e-3:
        bad.append(f"(b) test error {res['b']['test_error']:.5f} against phase 5's "
                   f"{bless_test_error:.5f}")
    want = "ShardedBackend" if x.shape[0] >= SHARD_MIN_ROWS else type(be).__name__
    if res["b"]["picked"] != [want] * world:
        bad.append(f"(b) the default pick for {x.shape[0]} rows in the group was "
                   f"{res['b']['picked']}, not {want}")
    if on_card and any(r["launches"]["falkon_matvec"] != iters for r in ranks):
        bad.append(f"(b) each rank's K2 launches {[r['launches']['falkon_matvec'] for r in ranks]}"
                   f" are not {iters}")

    # (c) the opt-in guard: the happy path, then a primary that dies once
    health.clear_events()
    guarded, guarded_s, guarded_launches = fit(GuardedBackend(primary=be))
    happy_events = len(health.events("backend_fallback"))
    skip = 2 + fault_call - 1  # K_MM's gram_block and knm_t hit the hook first
    dying, raised = None, None
    with faults.fault("backend.error", skip=skip, times=1) as f, warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        try:
            dying, _, _ = fit(GuardedBackend(primary=faults.FaultyBackend(be)))
        except faults.FaultInjected as e:
            raised = repr(e)
    sync(device)
    events = health.events("backend_fallback")
    res["c"] = {"fit_s": guarded_s, "launches": guarded_launches,
                "bit_identical": torch.equal(guarded.alpha, ref.alpha),
                "happy_events": happy_events, "fired": f.fired, "raised": raised,
                "events": [e["method"] for e in events],
                "event_fallbacks": [e["fallback"] for e in events],
                "dying_pred_err": None if dying is None else _rel(dying.predict(xte),
                                                                   ref.predict(xte))}
    health.clear_events()
    if not (res["c"]["bit_identical"] and guarded_launches == ref_launches and happy_events == 0):
        bad.append(f"(c) guarded happy path: bit-identical {res['c']['bit_identical']}, launches "
                   f"{guarded_launches} against {ref_launches}, events {happy_events}")
    want_fallbacks = [None] if on_card else [TorchBackend.name]
    if not (f.fired == 1 and res["c"]["events"] == ["knm_quadratic"]
            and res["c"]["event_fallbacks"] == want_fallbacks):
        bad.append(f"(c) the dying primary: fired {f.fired}, events {res['c']['events']}, "
                   f"fallbacks {res['c']['event_fallbacks']} (want {want_fallbacks})")
    if on_card and (raised is None or dying is not None):
        bad.append("(c) on the card the dying primary's fit was served instead of raising")
    if not on_card and not (dying is not None and res["c"]["dying_pred_err"] <= E2E_TOL):
        bad.append(f"(c) the guarded fit's predictions {res['c']['dying_pred_err']} of "
                   f"max|pred| from the clean fit's (raised {raised})")

    # (d) the fused fit, twice in one bucket, each against the host loop; an
    # empty plan cache first, so the first fit builds (captures) its plan
    falkon_mod.release_fused_plans()
    fits = {}
    for name, rows, lam_d, sig_d in (("first", fused_rows, lam, sigma),
                                     ("second", fused_rows - 1000, lam2, sigma2)):
        k_d = make_kernel("gaussian", sigma=sig_d)
        args = (k_d, x[:rows], y[:rows], z, lam_d)
        plans = falkon_mod._FUSED_FIT_TRACES
        sync(device)
        held = torch.cuda.memory_allocated() if on_card else 0
        t0 = time.perf_counter()
        fused = falkon_fit(*args, a_diag=a, iters=iters, backend="torch")
        sync(device)
        fused_s = time.perf_counter() - t0
        held = (torch.cuda.memory_allocated() if on_card else 0) - held
        built = falkon_mod._FUSED_FIT_TRACES - plans
        t0 = time.perf_counter()
        falkon_fit(*args, a_diag=a, iters=iters, backend="torch")
        sync(device)
        again_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = falkon_fit(*args, a_diag=a, iters=iters, backend="torch", fused=False)
        sync(device)
        host_s = time.perf_counter() - t0
        ref_d = fp64_referee(k_d, x[:rows], y[:rows], z, a, lam_d, iters, xte)
        pf, ph = fused.predict(xte), host.predict(xte)
        scale = float(ref_d.abs().max())
        fits[name] = {"rows": rows, "lam": lam_d, "sigma": sig_d, "plans_built": built,
                      "allocated_bytes_after": held,
                      "fit_s": fused_s, "repeat_fit_s": again_s, "host_fit_s": host_s,
                      "fused_fp64": float((pf.double() - ref_d).abs().max()) / scale,
                      "host_fp64": float((ph.double() - ref_d).abs().max()) / scale,
                      "pred_err": _rel(pf, ph), "alpha_err": _rel(fused.alpha, host.alpha),
                      "cg_residual_reduction": float(fused.diagnostics.reduction.max())}
    if on_card:
        block = TorchBackend().block
        n_pad = -(-fused_rows // block) * block
        plan = next(p for key, p in falkon_mod._FUSED_PLANS.items()
                    if key[0] == n_pad and key[2] == z.shape[0] and key[4] == iters)
        fits["replay_ms"] = _cuda_ms(plan.run, 3)
    res["d"] = fits
    falkon_mod.release_fused_plans()  # the plans' buffers and graph pools
    want_plans = (1, 0) if on_card else (0, 0)
    if (fits["first"]["plans_built"], fits["second"]["plans_built"]) != want_plans:
        bad.append(f"(d) plans built: {fits['first']['plans_built']} for the first fit, "
                   f"{fits['second']['plans_built']} for the second (want {want_plans})")
    if not fits["second"]["pred_err"] <= E2E_TOL:
        bad.append(f"(d) the second fused fit's predictions are {fits['second']['pred_err']:.3e} "
                   f"of max|pred| from the host loop's")
    for name in ("first", "second"):
        if not fits[name]["fused_fp64"] <= fits[name]["host_fp64"] + E2E_TOL:
            bad.append(f"(d) the {name} fused fit is {fits[name]['fused_fp64']:.3e} from its fp64 "
                       f"referee, farther than the host loop ({fits[name]['host_fp64']:.3e}) "
                       f"+ {E2E_TOL}")

    sync(device)
    res["launches"] = {name: count + sum(r[name] for r in res["b"]["launches"])
                       for name, count in kernels.launch_counts().items()}
    log(f"core_rest: {json.dumps(res)}")
    if on_card:
        missing = [name for name in CORE_REST_PATH if res["launches"][name] == 0]
        if missing:
            bad.append(f"kernels not launched on the sharded / guarded path: {missing}")
    if bad:
        raise PhaseError("core-rest failed: " + "; ".join(bad))
    return res


# ---------------------------------------------------------------------------
# 9-11. the LM: K8 and K9 parity, decode against forward, serving
# ---------------------------------------------------------------------------

#: K8 parity cases (B, Hq, Hkv, S, D, causal): GQA groups 1, 4, 6 and 8, ragged S
#: and D (D = 17 and S = 1 pad the tensor-core kernel's shared-memory tiles),
#: and Jamba's attention layer at 4 prompts of 2 048 tokens.
ATTN_CASES = [(1, 8, 8, 1000, 32, True), (1, 8, 2, 2053, 80, True), (1, 8, 1, 1000, 128, False),
              (2, 4, 1, 2053, 32, False), (4, 32, 8, 2048, 128, True), (1, 8, 2, 1000, 17, True),
              (2, 8, 8, 1, 128, True),
              # the 192- and 256-wide tiles: D = 256 causal and bidirectional at S of
              # one row, a ragged tile and many, gemma-2b's layer (B = 2, Hq = 8,
              # Hkv = 1, S = 2 048), and the ragged D = 129 and 200
              (1, 8, 1, 1, 256, True), (1, 8, 1, 1000, 256, True), (1, 8, 2, 2053, 256, True),
              (1, 8, 1, 1, 256, False), (1, 8, 2, 1000, 256, False), (1, 8, 1, 2053, 256, False),
              (2, 8, 1, 2048, 256, True), (1, 8, 2, 1000, 129, True), (1, 8, 1, 2053, 200, False),
              # the reference's padded heads as the main paths run them: gemma-2b's
              # 16 over one kv head in phase 15's steps and phase 14's exact prefill,
              # granite-moe's 32 over 8 (group 4) in phase 20 (a), a qwen2-vl rank's 4
              # of 16 over one of 2 (group 8) on model = 4 in phase 20 (b), and
              # llama4-scout-17b-a16e's 48 over 8 (group 6)
              (2, 16, 1, 2048, 256, True), (1, 16, 1, 8192, 256, True),
              (2, 32, 8, 512, 64, True), (2, 4, 1, 1280, 128, True), (1, 48, 8, 1024, 128, True)]
#: K9 parity cases (B, S, H, P, N, chunk): S not a multiple of the chunk, a
#: state carried over 65 chunks with H not a multiple of the 8-head scan
#: group, Jamba's Mamba layer at 4 prompts of 2 048 tokens with the model's
#: chunk, and mamba2-370m's (N = 128) at 4 sequences of 2 048 tokens.
SSD_CASES = [(1, 1000, 3, 64, 16, 64), (2, 2053, 4, 32, 8, 128), (1, 4100, 12, 64, 16, 64),
             (4, 2048, 128, 64, 16, 64), (4, 2048, 32, 64, 128, 64)]
#: K8 at gemma-2b's attention layer (B, Hq, Hkv, S, D), its 8 q heads padded
#: to 16, and K9 at mamba2-370m's Mamba layer (B, S, H, P, N): phase 15's
#: shapes, timed in phase 9; K8 also at gemma-2b's 8 published heads, timed
#: beside them (the padding's cost in the kernel).
GEMMA_ATTN = (2, 16, 1, 2048, 256)
GEMMA_ATTN_PUBLISHED = (2, 8, 1, 2048, 256)
MAMBA_SSD = (4, 2048, 32, 64, 128)


def lm_config(*, n_layers: int = 8, **overrides):
    """Jamba v0.1 at full width, cut to ``n_layers`` (one period group of 8:
    the 32 layers' 52 B parameters, 104 GB in bf16, exceed the card)."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(LM_ARCH), n_layers=n_layers, **overrides)


def attention_inputs(device, b, hq, hkv, s, d, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn((b, h, s, d), generator=g, device=device).to(dtype)
                 for h in (hq, hkv, hkv))


def ssd_inputs(device, b, s, h, p, n, dtype, seed):
    """x, dt = softplus(N(0, 1)), a = -exp(0.3 N(0, 1)), B, C = 0.5 N(0, 1):
    the reference kernel tests' distributions; x, B and C in ``dtype`` (as
    the Mamba block's convolution gives them), dt and a in fp32."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=g, device=device).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g, device=device))
    a = -torch.exp(0.3 * torch.randn((h,), generator=g, device=device))
    bm = (0.5 * torch.randn((b, s, n), generator=g, device=device)).to(dtype)
    cm = (0.5 * torch.randn((b, s, n), generator=g, device=device)).to(dtype)
    return x, dt, a, bm, cm


def lm_kernel_parity(device, *, attn_cases=ATTN_CASES, ssd_cases=SSD_CASES, seed: int = 0) -> dict:
    """Phase 9: K8 and K9 against their plain versions on ``device``, fp32
    and bf16; returns {kernel: worst fp32 max abs error}; raises past a
    tolerance (each scaled to max|ref|)."""
    from repro_torch.kernels import flash_attention_ops as fa
    from repro_torch.kernels import ssd_ops as so

    worst = {"flash_attention": 0.0, "ssd": 0.0}
    bad = []

    def check(name, tag, out, ref, tol, fp32, per_row=False):
        out, ref = out.float(), ref.float()
        err, scale = _err(out, ref)
        row_err = _row_err(out, ref) if per_row else 0.0
        log(f"parity {name}/{tag}: max_abs_err={err:.3e} tol={tol * scale:.3e} "
            f"max|ref|={scale:.3e}" + (f" row_err={row_err:.3e} row_tol={tol:.3e}"
                                       if per_row else ""))
        if fp32:
            worst[name] = max(worst[name], err)
        if out.shape != ref.shape or not err <= tol * scale:
            bad.append(f"{name}/{tag}: {err:.3e} > {tol * scale:.3e}")
        if not row_err <= tol:
            bad.append(f"{name}/{tag}: row error {row_err:.3e} > {tol:.3e}")

    for i, (b, hq, hkv, s, d, causal) in enumerate(attn_cases):
        for dtype in (torch.float32, torch.bfloat16):
            fp32 = dtype == torch.float32
            q, k, v = attention_inputs(device, b, hq, hkv, s, d, dtype, seed + i)
            tag = f"{b}x{hq}/{hkv}x{s}x{d}/{'causal' if causal else 'full'}/{str(dtype)[6:]}"
            check("flash_attention", tag, fa.flash_attention(q, k, v, causal=causal),
                  fa.flash_attention_reference(q, k, v, causal=causal),
                  ATTN_TOL if fp32 else ATTN_BF16_TOL, fp32, per_row=True)
            del q, k, v
    for i, (b, s, h, p, n, chunk) in enumerate(ssd_cases):
        for dtype in (torch.float32, torch.bfloat16):
            fp32 = dtype == torch.float32
            args = ssd_inputs(device, b, s, h, p, n, dtype, seed + 100 + i)
            y, st = so.ssd(*args, chunk=chunk)
            yr, sr = so.ssd_reference(*args, chunk=chunk)
            tag = f"{b}x{s}x{h}x{p}x{n}/chunk{chunk}/{str(dtype)[6:]}"
            tol = SSD_TOL if fp32 else SSD_BF16_TOL
            check("ssd", tag + "/y", y, yr, tol, fp32)
            check("ssd", tag + "/state", st, sr, tol, fp32)
            del args, y, st, yr, sr
    sync(device)
    if bad:
        raise PhaseError("LM kernel parity failed: " + "; ".join(bad))
    return worst


def _free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def decode_vs_forward(device, cfg=None, *, prompt: int = 128, seed: int = 0) -> dict:
    """Phase 10: one prompt through ``prefill_logits`` (K8 + K9 on the card)
    against ``prompt`` ``decode_step`` calls (no kernel) on the same tokens,
    in fp32 with ``capacity_factor`` 16 so the forward drops no token (the
    reference test's setting). Counts reset before each and read after;
    gate: max|delta| <= 5e-3 max|logit|, K8 >= 1 and K9 >= 7 launches in the
    forward, none in the decode."""
    from repro_torch import kernels
    from repro_torch.models import LM
    from repro_torch.serving import prefill_logits

    cfg = cfg or lm_config(dtype="float32", capacity_factor=16.0)
    t0 = time.perf_counter()
    lm = LM(cfg, seed=seed, device=str(device))
    sync(device)
    init_s = time.perf_counter() - t0
    g = torch.Generator(device=device).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (1, prompt), generator=g, device=device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    want = prefill_logits(lm, {"tokens": tokens}).float()
    sync(device)
    forward_s = time.perf_counter() - t0
    fwd_launches = kernels.launch_counts()
    kernels.reset_launch_counts()
    cache = lm.init_cache(1, prompt)
    t0 = time.perf_counter()
    for t in range(prompt):
        got = lm.decode_step(cache, tokens[:, t], t, length=t + 1)
    sync(device)
    decode_s = time.perf_counter() - t0
    dec_launches = kernels.launch_counts()
    err, scale = _err(got.float(), want)
    n_attn = sum(cfg.mixer_kind(i) == "attn" for i in range(cfg.n_layers))
    n_mamba = cfg.n_layers - n_attn
    res = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "capacity_factor": cfg.capacity_factor, "prompt": prompt,
           "params": sum(p.numel() for p in lm.parameters()), "init_s": init_s,
           "forward_s": forward_s, "decode_s": decode_s, "max_abs_delta": err,
           "max_logit": scale, "delta_over_max": err / scale,
           "forward_launches": {n: fwd_launches[n] for n in LM_KERNELS},
           "decode_launches": {n: dec_launches[n] for n in LM_KERNELS},
           "launches": fwd_launches}
    log(f"decode vs forward: {json.dumps({k: v for k, v in res.items() if k != 'launches'})}")
    del lm, cache, want, got
    _free(device)
    bad = []
    if not err <= DECODE_TOL * scale:
        bad.append(f"decode differs from the forward by {err:.3e} > {DECODE_TOL} x {scale:.3e}")
    if torch.device(device).type == "cuda":
        if fwd_launches["flash_attention"] < n_attn or fwd_launches["ssd"] < n_mamba:
            bad.append(f"the forward launched K8 {fwd_launches['flash_attention']} and K9 "
                       f"{fwd_launches['ssd']} times (want >= {n_attn} and >= {n_mamba})")
    if any(dec_launches[n] for n in LM_KERNELS):
        bad.append(f"the decode launched an LM kernel: {res['decode_launches']}")
    if bad:
        raise PhaseError("decode vs forward failed: " + "; ".join(bad))
    return res


def _ops_ms(contractions: float, elementwise: float, tensor_cores: bool) -> float:
    """Least ms for the operations: the contractions over the bf16
    tensor-core peak (``tensor_cores``) or the fp32 peak, the elementwise
    work over the fp32 peak, the two times added."""
    peak = PEAK_BF16_TENSOR_FLOPS if tensor_cores else PEAK_FP32_FLOPS
    return (contractions / peak + elementwise / PEAK_FP32_FLOPS) * 1e3


def attention_bound(b, hq, hkv, s, d, causal, itemsize, *,
                    tensor_cores: bool | None = None) -> tuple[float, str]:
    """(least ms, bound) for K8: q, k, v read and the output written once;
    per unmasked (query, key) pair 4 D operations in the two contractions
    and 4 in the softmax (max, subtract, exp, sum). With bf16 operands
    (``itemsize`` 2; ``tensor_cores`` overrides) the contractions go over
    the bf16 tensor-core peak, as a flash attention on the tensor cores
    (scaled_dot_product_attention) runs them; with fp32 operands over the
    fp32 peak."""
    if tensor_cores is None:
        tensor_cores = itemsize == 2
    pairs = s * (s + 1) // 2 if causal else s * s
    nbytes = itemsize * (2 * b * hq * s * d + 2 * b * hkv * s * d)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = _ops_ms(b * hq * pairs * 4 * d, b * hq * pairs * 4, tensor_cores)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssd_states_bytes(b, s, h, p, n, chunk) -> int:
    """Bytes of K9's chunk states, (B, ceil(S / chunk), H, P, N) fp32."""
    return 4 * b * -(-s // chunk) * h * p * n


def ssd_bound(b, s, h, p, n, chunk, itemsize, *, tensor_cores: bool | None = None,
              design: bool = False) -> tuple[float, str]:
    """(least ms, bound) for K9 at ``chunk``: x, B, C read and y written
    once in their dtype (``itemsize``), dt read and the state written once
    in fp32. Contractions per chunk of Q rows: C B^T once per batch row (2 N
    per pair k <= q); per head y_diag (2 P per pair), y_off and the state
    (2 P N per row each). Elementwise per head: L and C B^T * L (3 per
    pair), the decays of y_off and of dt x (2 P per row), the state's decay
    and sum (2 P N). Contractions over the bf16 tensor-core peak with bf16 operands
    (``tensor_cores`` overrides), else over the fp32 peak. ``design`` adds
    the bytes ssd.cu's three launches move beyond one pass: the chunk states
    written, read, rewritten and read (4 x ``ssd_states_bytes``), their
    decays written and read, and x, B and dt read a second time."""
    if tensor_cores is None:
        tensor_cores = itemsize == 2
    nbytes = itemsize * (2 * b * s * h * p + 2 * b * s * n) + 4 * (b * s * h + h + b * h * p * n)
    if design:
        nbytes += (4 * ssd_states_bytes(b, s, h, p, n, chunk) + 2 * 4 * b * -(-s // chunk) * h
                   + itemsize * (b * s * h * p + b * s * n) + 4 * b * s * h)
    contractions = elementwise = 0
    for c0 in range(0, s, chunk):
        q = min(chunk, s - c0)
        pairs = q * (q + 1) // 2
        contractions += b * 2 * n * pairs + b * h * (pairs * 2 * p + q * 4 * p * n)
        elementwise += b * h * (pairs * 3 + q * 2 * p + 2 * p * n)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = _ops_ms(contractions, elementwise, tensor_cores)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def serve(device, cfg=None, *, batch: int = 4, prompt: int = 2048, repeats: int = 3,
          slots: int = 4, max_len: int = 256, serve_prompt: int = 32, steps: int = 32,
          join_at: int = 8, seed: int = 0) -> dict:
    """Phase 11, in the model's dtype: ``prefill_logits`` on ``batch`` prompts
    of ``prompt`` tokens timed warm (prefill tokens/s), then ServeEngine with
    ``slots`` slots: three requests of ``serve_prompt`` tokens start, a
    fourth joins after ``join_at`` steps, ``steps`` decode steps (decode
    tokens/s). Counts reset before the prefill and read after the serving.
    Then K8 and K9 at the shapes the prefill gives them (``lm_kernel_times``).
    Gates: finite logits, each slot's output as long as its steps."""
    from repro_torch import kernels
    from repro_torch.models import LM, mamba2
    from repro_torch.models.model import model_dtype
    from repro_torch.serving import ServeEngine, prefill_logits

    cfg = cfg or lm_config()
    on_card = torch.device(device).type == "cuda"
    lm = LM(cfg, seed=seed, device=str(device))
    g = torch.Generator(device=device).manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g, device=device)
    logits = prefill_logits(lm, {"tokens": tokens})  # warm-up
    sync(device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(repeats):
        logits = prefill_logits(lm, {"tokens": tokens})
    sync(device)
    prefill_s = (time.perf_counter() - t0) / repeats
    finite = bool(torch.all(torch.isfinite(logits.float())))

    eng = ServeEngine(lm, max_len=max_len, batch_slots=slots, device=str(device))
    prompts = torch.randint(0, cfg.vocab_size, (slots, serve_prompt),
                            generator=torch.Generator().manual_seed(seed + 2)).tolist()
    t0 = time.perf_counter()
    for slot in range(slots - 1):
        eng.add_request(slot, prompts[slot])
    sync(device)
    add_s = time.perf_counter() - t0
    decode_s, decoded = 0.0, 0
    for i in range(steps):
        if i == join_at:
            t0 = time.perf_counter()
            eng.add_request(slots - 1, prompts[slots - 1])
            sync(device)
            add_s += time.perf_counter() - t0
        active = int(eng.active.sum())
        t0 = time.perf_counter()
        eng.step()
        sync(device)
        decode_s += time.perf_counter() - t0
        decoded += active
    launches = kernels.launch_counts()
    last = lm.decode_step(eng.cache, eng.tokens, eng.pos, length=eng.pos + 1)
    finite = finite and bool(torch.all(torch.isfinite(last.float())))
    outputs = [eng.finish(s) for s in range(slots)]
    want_len = [1 + steps] * (slots - 1) + [1 + steps - join_at]
    res = {"arch": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype, "batch": batch,
           "prompt": prompt, "prefill_s": prefill_s, "prefill_tokens_per_s":
           batch * prompt / prefill_s, "serve_slots": slots, "serve_prompt": serve_prompt,
           "decode_steps": steps, "decode_s": decode_s, "decode_tokens_per_s": decoded / decode_s,
           "decode_ms_per_step": decode_s / steps * 1e3, "add_request_s": add_s,
           "logits_finite": finite, "output_lengths": [len(o) for o in outputs],
           "launches": launches}
    log(f"serve: {json.dumps({k: v for k, v in res.items() if k != 'launches'})}")
    for s, out in enumerate(outputs):
        log(f"serve slot {s}: {json.dumps(out)}")

    del eng, logits, last, lm
    _free(device)
    # K8 and K9 at the prefill's shapes: Jamba's attention layer and Mamba layer
    res["kernels"] = lm_kernel_times(
        device, (batch, cfg.padded_heads(), cfg.padded_kv_heads(), prompt, cfg.head_dim),
        (batch, prompt, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state), mamba2.CHUNK,
        model_dtype(cfg), seed=seed, timed=on_card)
    _free(device)
    bad = []
    if not finite:
        bad.append("non-finite logits")
    if res["output_lengths"] != want_len:
        bad.append(f"output lengths {res['output_lengths']}, want {want_len}")
    if on_card and not (launches["flash_attention"] >= 1 and launches["ssd"] >= 1):
        bad.append(f"kernels not launched on the serving path: "
                   f"{ {n: launches[n] for n in LM_KERNELS} }")
    if bad:
        raise PhaseError("serve failed: " + "; ".join(bad))
    return res


def attn_times(device, attn_shape, dtype, *, seed: int = 0, timed: bool = True,
               repeats: int = 5, plain_repeats: int = 2, bad: list | None = None) -> dict:
    """K8 (causal) at ``attn_shape`` (B, Hq, Hkv, S, D) in ``dtype``: parity
    with the plain version (phase 9's tolerances; a miss appended to
    ``bad``) and, if ``timed``, CUDA-event times of kernel, plain version
    and SDPA beside the bound."""
    def ms(fn, r):
        return _cuda_ms(fn, r) if timed else None

    from repro_torch.kernels import flash_attention_ops as fa

    bad = [] if bad is None else bad
    bf16 = dtype == torch.bfloat16
    b, hq, hkv, s, d = attn_shape
    q, k, v = attention_inputs(device, b, hq, hkv, s, d, dtype, seed)
    o, r = (fa.flash_attention(q, k, v, causal=True).float(),
            fa.flash_attention_reference(q, k, v, causal=True).float())
    (err, scale), row_err = _err(o, r), _row_err(o, r)
    del o, r
    row_tol = ATTN_BF16_TOL if bf16 else ATTN_TOL
    tol = row_tol * scale
    if not err <= tol:
        bad.append(f"flash_attention: {err:.3e} > {tol:.3e}")
    if not row_err <= row_tol:
        bad.append(f"flash_attention: row error {row_err:.3e} > {row_tol:.3e}")
    b_ms, b_by = attention_bound(b, hq, hkv, s, d, True, q.element_size())
    res = {
        "shape": list(attn_shape), "dtype": str(dtype)[6:], "causal": True,
        "design": "mma.sync bf16" if bf16 else "fp32 FMA", "max_abs_err": err, "tol": tol,
        "row_err": row_err, "row_tol": row_tol,
        "ms": ms(lambda: fa.flash_attention(q, k, v, causal=True), repeats),
        "plain_ms": ms(lambda: fa.flash_attention_reference(q, k, v, causal=True),
                       plain_repeats),
        "library_ms": ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), repeats),
        "bound_ms": b_ms, "bound_by": b_by,
        "bound_fp32_ms": attention_bound(b, hq, hkv, s, d, True, q.element_size(),
                                         tensor_cores=False)[0]}
    del q, k, v
    return res


def lm_kernel_times(device, attn_shape, ssd_shape, chunk, dtype, *, seed: int = 0,
                    timed: bool = True, repeats: int = 5, plain_repeats: int = 2,
                    default_chunk: int = 128) -> dict:
    """K8 (causal) at ``attn_shape`` (B, Hq, Hkv, S, D) and K9 at
    ``ssd_shape`` (B, S, H, P, N) and ``chunk``, on phase 9's inputs in
    ``dtype``: parity with the plain version (phase 9's tolerances) and, if
    ``timed``, CUDA-event times of kernel, plain version and library call
    (SDPA for K8; none for K9) beside the bound (K9: the one-pass bound and
    its design's, which counts the chunk states). K9 is also checked and
    timed at the wrapper's ``default_chunk``."""
    def ms(fn, r):
        return _cuda_ms(fn, r) if timed else None

    from repro_torch.kernels import ssd_ops as so

    bf16 = dtype == torch.bfloat16
    out, bad = {}, []
    out["flash_attention"] = attn_times(device, attn_shape, dtype, seed=seed, timed=timed,
                                        repeats=repeats, plain_repeats=plain_repeats, bad=bad)
    bsz, sl, h, p, n = ssd_shape
    args = ssd_inputs(device, bsz, sl, h, p, n, dtype, seed + 100)
    stol = SSD_BF16_TOL if bf16 else SSD_TOL
    for c in (chunk, default_chunk):
        y, st = so.ssd(*args, chunk=c)
        yr, sr = so.ssd_reference(*args, chunk=c)
        (ey, sy), (es, ss) = _err(y.float(), yr.float()), _err(st, sr)
        del y, st, yr, sr
        if not (ey <= stol * sy and es <= stol * ss):
            bad.append(f"ssd/chunk{c}: y {ey:.3e} (tol {stol * sy:.3e}), state {es:.3e} "
                       f"(tol {stol * ss:.3e})")
        b_ms, b_by = ssd_bound(bsz, sl, h, p, n, c, args[0].element_size())
        d_ms, d_by = ssd_bound(bsz, sl, h, p, n, c, args[0].element_size(), design=True)
        out["ssd" if c == chunk else f"ssd_chunk{c}"] = {
            "shape": list(ssd_shape), "chunk": c, "dtype": str(dtype)[6:],
            "max_abs_err": max(ey, es), "y_err": ey, "y_tol": stol * sy, "state_err": es,
            "state_tol": stol * ss, "ms": ms(lambda: so.ssd(*args, chunk=c), repeats),
            "plain_ms": ms(lambda: so.ssd_reference(*args, chunk=c), plain_repeats),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "bound_fp32_ms": ssd_bound(bsz, sl, h, p, n, c, args[0].element_size(),
                                       tensor_cores=False)[0],
            "design_bound_ms": d_ms, "design_bound_by": d_by,
            "states_bytes": ssd_states_bytes(bsz, sl, h, p, n, c)}
        if c == chunk == default_chunk:
            break
    for name, t in out.items():
        log(f"times {name}: {json.dumps(t)}")
    if bad:
        raise PhaseError("LM kernels at the main path's shapes: " + "; ".join(bad))
    return out


def wide_kernel_times(device, *, attn_shape=GEMMA_ATTN, ssd_shape=MAMBA_SSD,
                      published_shape=GEMMA_ATTN_PUBLISHED, seed: int = 0,
                      timed: bool = True) -> dict:
    """Phase 9's times at this slice's shapes: K8 at gemma-2b's attention
    layer (``GEMMA_ATTN``) and K9 at mamba2-370m's Mamba layer
    (``MAMBA_SSD``, the model's chunk; N = 128 leaves no room for chunk 128),
    in bf16 (the models' dtype) and fp32 (phase 15 (c)'s): parity with the
    plain version and CUDA-event times of kernel, plain version and (K8)
    SDPA beside the bound; then K8 at ``published_shape`` (gemma-2b's 8
    published q heads), bf16, the same."""
    from repro_torch.models import mamba2

    out, bad = {}, []
    for dtype in (torch.bfloat16, torch.float32):
        got = lm_kernel_times(device, attn_shape, ssd_shape, mamba2.CHUNK, dtype, seed=seed,
                              timed=timed, default_chunk=mamba2.CHUNK)
        tag = "" if dtype == torch.bfloat16 else "@fp32"
        out[f"flash_attention@gemma{tag}"] = got["flash_attention"]
        out[f"ssd@mamba{tag}"] = got["ssd"]
    out["flash_attention@gemma-published"] = attn_times(
        device, published_shape, torch.bfloat16, seed=seed, timed=timed, bad=bad)
    log(f"times flash_attention@gemma-published: "
        f"{json.dumps(out['flash_attention@gemma-published'])}")
    if bad:
        raise PhaseError("K8 at gemma-2b's published heads: " + "; ".join(bad))
    return out


#: phase 14: gemma-2b at full width and depth through BLESS-Nystrom attention.
NYSTROM_ARCH = "gemma-2b"
NYSTROM_LANDMARKS = 1024
NYSTROM_TOL = 1e-3


def nystrom_config(**overrides):
    """gemma-2b at full width and full depth (18 layers, bf16) with
    BLESS-Nystrom attention past ``NYSTROM_LANDMARKS`` positions."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(NYSTROM_ARCH), attention_impl="bless_nystrom",
                               nystrom_landmarks=NYSTROM_LANDMARKS, **overrides)


def _same_selection(idx: torch.Tensor, ref_idx: torch.Tensor, ref_scores: torch.Tensor) -> dict:
    """Compare two top-m selections per leading index (b, kv head): each
    (..., m) index set against ``ref_idx`` with the reference's scores
    (..., S). Indices in one set and not the other are excepted only where
    their reference score ties the m-th largest one within the RLS
    tolerance (a tie at the selection's edge, the clip among them)."""
    idx, ref_idx, ref_scores = idx.cpu(), ref_idx.cpu(), ref_scores.cpu()
    m = idx.shape[-1]
    edge = torch.sort(ref_scores, dim=-1, descending=True).values[..., m - 1]
    differ, untied = 0, 0
    for j in range(idx.reshape(-1, m).shape[0]):
        a, b = set(idx.reshape(-1, m)[j].tolist()), set(ref_idx.reshape(-1, m)[j].tolist())
        sc, e = ref_scores.reshape(-1, ref_scores.shape[-1])[j], float(edge.reshape(-1)[j])
        diff = sorted(a ^ b)
        differ += len(diff)
        untied += sum(abs(float(sc[i]) - e) > SCORE_ATOL + SCORE_RTOL * abs(e) for i in diff)
    return {"differ": differ, "untied": untied}


def nystrom(device, cfg=None, *, prompt: int = 8192, repeats: int = 2, seed: int = 0) -> dict:
    """Phase 14. (a) ``prefill_logits`` of ``cfg`` (gemma-2b, BLESS-Nystrom
    attention, 1 024 landmarks) on one ``prompt``-token prompt, timed warm,
    beside the same model with exact attention (K8 at D = 256); counts reset
    before each and read after. (b) The first attention layer's q, k, v at
    that prompt, in fp32: ``nystrom_attention`` on ``device`` against the
    same function on the CPU (landmark sets equal per (b, kv head) but for
    ties at the edge, outputs within 1e-3 of max|out|), and its error
    against exact bidirectional attention logged. (c) ``bless_compress_cache``
    of that layer's k and v down to the landmark count: the kept rows the
    CPU's selection as sets; its time logged. Gates: finite logits, K8
    launched in every layer of the exact prefill and in none of the Nystrom
    one, no plain K8 on the card."""
    from repro_torch import kernels
    from repro_torch.models import LM
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import rms_norm
    from repro_torch.serving import prefill_logits

    cfg = cfg or nystrom_config()
    on_card = torch.device(device).type == "cuda"
    m = cfg.nystrom_landmarks
    n_attn = sum(cfg.mixer_kind(i) == "attn" for i in range(cfg.n_layers))
    g = torch.Generator(device=device).manual_seed(seed + 3)
    tokens = torch.randint(0, cfg.vocab_size, (1, prompt), generator=g, device=device)

    def timed_prefill(lm):
        logits = prefill_logits(lm, {"tokens": tokens})  # warm-up
        sync(device)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(repeats):
            logits = prefill_logits(lm, {"tokens": tokens})
        sync(device)
        return (logits, (time.perf_counter() - t0) / repeats, kernels.launch_counts(),
                kernels.plain_counts())

    lm = LM(cfg, seed=seed, device=str(device))
    logits, nys_s, nys_launches, nys_plain = timed_prefill(lm)
    res = {"arch": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype, "prompt": prompt,
           "landmarks": m, "nystrom_prefill_s": nys_s,
           "nystrom_logits_finite": bool(torch.all(torch.isfinite(logits.float()))),
           "nystrom_launches": {n: nys_launches[n] for n in LM_KERNELS}}
    # (b) the first attention layer's q, k, v
    li = next(i for i in range(cfg.n_layers) if cfg.mixer_kind(i) == "attn")
    with torch.no_grad():
        x = lm._embed_in({"tokens": tokens})
        h = rms_norm(x, lm.layers[li].ln_mix, cfg.norm_eps)
        positions = torch.arange(prompt, device=device).expand(1, prompt)
        q16, k16, v16 = lm.layers[li].attn._qkv(h, positions, None)
    del lm, logits, x, h
    _free(device)
    q, k, v = (t.float().contiguous() for t in (q16, k16, v16))
    keys = k.permute(0, 2, 1, 3)  # (B, Hkv, S, D)
    with torch.no_grad():
        out = attn.nystrom_attention(q, k, v, landmarks=m)
        idx = attn.bless_topm_landmarks(keys, m)
        qc, kc, vc = (t.cpu() for t in (q, k, v))
        out_cpu = attn.nystrom_attention(qc, kc, vc, landmarks=m)
        idx_cpu = attn.bless_topm_landmarks(kc.permute(0, 2, 1, 3), m)
        sc_cpu = attn.rls_scores_one_rung(kc.permute(0, 2, 1, 3), 128, 1e-3)
        sc = attn.rls_scores_one_rung(keys, 128, 1e-3)
        exact = attn.attention(q, k, v, causal=False)
    err, scale = _err(out.cpu(), out_cpu)
    res["layer"] = {"index": li, "shape": list(q.shape), "landmarks": _same_selection(
        idx, idx_cpu, sc_cpu), "score_err": _score_err(sc.cpu(), sc_cpu)[1],
        "max_abs_err": err, "max_out": scale, "err_over_max": err / scale,
        "vs_exact_rel_fro": float(torch.linalg.norm(out - exact) / torch.linalg.norm(exact)),
        "nystrom_ms": (_cuda_ms(lambda: attn.nystrom_attention(q, k, v, landmarks=m), 2)
                       if on_card else None),
        "exact_k8_fp32_ms": (_cuda_ms(lambda: attn.attention(q, k, v, causal=False), 2)
                             if on_card else None)}
    del out, out_cpu, exact, q, qc
    # (c) the cache compressed to m rows per (b, kv head), in the cache's dtype
    with torch.no_grad():
        kk, vv = attn.bless_compress_cache(k16, v16, m)
        kk_cpu, vv_cpu = attn.bless_compress_cache(k16.cpu(), v16.cpu(), m)
        cidx = attn.bless_topm_landmarks(k16.permute(0, 2, 1, 3), m, m_pilot=256, lam=1e-4)
        cidx_cpu = attn.bless_topm_landmarks(k16.cpu().permute(0, 2, 1, 3), m, m_pilot=256,
                                              lam=1e-4)
        csc_cpu = attn.rls_scores_one_rung(k16.cpu().permute(0, 2, 1, 3), 256, 1e-4)
    rows = {tuple(r) for r in kk.float().cpu()[0, :, 0].tolist()}
    rows_cpu = {tuple(r) for r in kk_cpu.float()[0, :, 0].tolist()}
    res["compress"] = {"m": m, "shape": list(kk.shape), "selection": _same_selection(
        cidx, cidx_cpu, csc_cpu), "rows_equal_as_sets": rows == rows_cpu,
        "values_gathered": bool(torch.equal(vv.cpu()[0, :, 0], v16.cpu()[0, cidx.cpu()[0, 0], 0])),
        "ms": (_cuda_ms(lambda: attn.bless_compress_cache(k16, v16, m), 2) if on_card else None)}
    del kk, vv, k, v, keys
    _free(device)
    # (a) beside it: the same model with exact attention (K8 at D = 256)
    lm = LM(dataclasses.replace(cfg, attention_impl="full"), seed=seed, device=str(device))
    logits, exact_s, launches, plain = timed_prefill(lm)
    res.update({"exact_prefill_s": exact_s,
                "exact_logits_finite": bool(torch.all(torch.isfinite(logits.float()))),
                "launches": launches, "plain": plain})
    del lm, logits
    _free(device)
    log(f"nystrom: {json.dumps({k: v for k, v in res.items() if k != 'launches'})}")
    bad = []
    if not (res["nystrom_logits_finite"] and res["exact_logits_finite"]):
        bad.append("non-finite logits")
    if res["layer"]["landmarks"]["untied"] or res["compress"]["selection"]["untied"]:
        bad.append(f"landmark sets differ beyond ties: {res['layer']['landmarks']}, "
                   f"{res['compress']['selection']}")
    if not (res["layer"]["err_over_max"] <= NYSTROM_TOL):
        bad.append(f"card against CPU {res['layer']['err_over_max']:.3e} > {NYSTROM_TOL}")
    if not res["compress"]["values_gathered"]:
        bad.append("the compressed values are not the selected rows")
    if not res["compress"]["selection"]["differ"] and not res["compress"]["rows_equal_as_sets"]:
        bad.append("the compressed caches differ as sets")
    if on_card:
        if launches["flash_attention"] < n_attn * repeats or nys_launches["flash_attention"]:
            bad.append(f"K8 launched {launches['flash_attention']} times in {repeats} exact "
                       f"prefills and {nys_launches['flash_attention']} in the Nystrom ones")
        if any(c["cuda_calls"] for c in (*plain.values(), *nys_plain.values())):
            bad.append(f"a plain kernel version ran on the card: {plain}, {nys_plain}")
    if bad:
        raise PhaseError("nystrom failed: " + "; ".join(bad))
    return res


#: phase 15: each trainer's peak learning rate (cosine, ``TRAIN_WARMUP``
#: warmup steps, 100 steps; chosen within 3e-4 to 3e-3) and the gradient
#: clip. AdamW's first steps move every parameter by about the lr, whatever
#: its gradient. In this phase on the card with one warmup step, gemma-2b's
#: loss over six steps went 12.837 ... 12.765, 12.813, 12.879 at 1e-3 (its
#: 2.5 B parameters drift, and the loss rises after the fourth step), jumped
#: to 13.82 at the sixth at 2e-3, and fell to 12.760 at 5e-4; with three
#: warmup steps it fell to 12.741 at 5e-4, and mamba2-370m's from 11.217 to
#: 11.189 at 1e-3.
TRAIN_PEAK_LR = {"gemma-2b": 5e-4, "mamba2-370m": 1e-3}
#: the SyntheticLM batches (by index) whose loss phase 15 compares before and
#: after its steps: none of them is a training batch. The same batch on both
#: sides: the loss of one batch against another's varies by more than six
#: steps move it (PERF.md section 6). TRAINED: a batch the first step trains
#: on, its loss logged before and after the steps beside them (no gate).
HELD_OUT = (100, 101)
TRAINED = (0,)
#: warmup steps: the lr climbs over steps 1-3, so the first steps (whose
#: AdamW moves are about the lr on every parameter, whatever its gradient)
#: are not full-lr moves of the random parameters.
TRAIN_WARMUP = 3
TRAIN_CLIP = 1.0
TRAIN_GRAD_TOL = 1e-3
TRAIN_LOSS_RTOL = 1e-4


def _opt_config(peak_lr: float):
    from repro_torch.optim import OptConfig

    return OptConfig(peak_lr=peak_lr, warmup=TRAIN_WARMUP, total_steps=100, schedule="cosine",
                     clip_norm=TRAIN_CLIP)


def _cpu_template(state):
    """``state``'s structure with plain-number leaves: restore_checkpoint then
    gives CPU tensors (no second copy of the state on the card)."""
    from repro_torch.training import TrainState

    return TrainState(params={k: 0 for k in state.params},
                      opt={"step": 0, **{n: {k: 0 for k in state.opt[n]}
                                         for n in ("master", "mu", "nu")}})


def train_run(device, cfg, *, batch: int, seq: int, peak_lr: float, steps: int = 6,
              loss_chunks: int = 8, resume: bool = False, seed: int = 0) -> dict:
    """``steps`` AdamW steps of ``cfg`` from random weights on ``SyntheticLM``
    batches (B = ``batch``, S = ``seq``), microbatches = 1; counts reset
    before each step and read after. With ``resume``: the state saved with
    ``repro_torch.checkpoint`` after the last step, then a step at
    microbatches = 2 taken from it, the checkpoint restored into the state
    (through host memory) and the same step taken again: the two losses
    must be the same bits. Gates: loss and grad_norm finite at every step,
    the loss of each of HELD_OUT's batches (which no step trains on) lower
    after the steps than before them, the model's kernel (K8 for
    attention, K9 for Mamba layers) launched in every layer of every forward
    (twice under remat: the backward recomputes each layer), and every plain
    call on the card a backward recompute."""
    import shutil
    import tempfile

    from repro_torch import kernels
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.data import SyntheticLM
    from repro_torch.models import LM, loss_fn
    from repro_torch.training import copy_state_, make_train_step, train_state_init

    on_card = torch.device(device).type == "cuda"
    n_attn = sum(cfg.mixer_kind(i) == "attn" for i in range(cfg.n_layers))
    want = {"flash_attention": n_attn, "ssd": cfg.n_layers - n_attn}
    want = {k: v * (2 if cfg.remat else 1) for k, v in want.items()}
    t0 = time.perf_counter()
    lm = LM(cfg, seed=seed, device=str(device))
    state = train_state_init(lm)
    sync(device)
    init_s = time.perf_counter() - t0
    opt = _opt_config(peak_lr)
    step = make_train_step(lm, opt, loss_chunks=loss_chunks)
    pipe = SyntheticLM(cfg.vocab_size, batch, seq, seed=seed, device=str(device))

    def losses_at(batches) -> list[float]:  # the state's params are the model's own tensors
        with torch.no_grad():
            return [float(loss_fn(lm, pipe.batch_at(i), n_chunks=loss_chunks))
                    for i in batches]

    before, trained_before = losses_at(HELD_OUT), losses_at(TRAINED)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    records, bad = [], []
    launches = {n: 0 for n in LM_KERNELS}

    def one(step_fn, i):
        b = pipe.batch_at(i)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        st, met = step_fn(state, b)
        sync(device)
        rec = {"step": i + 1, "loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
               "lr": float(met["lr"]), "s": time.perf_counter() - t0,
               "launches": {n: kernels.launch_counts()[n] for n in LM_KERNELS},
               "plain": kernels.plain_counts()}
        for n in LM_KERNELS:
            launches[n] += rec["launches"][n]
        if not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"])):
            bad.append(f"step {i + 1}: loss {rec['loss']}, grad_norm {rec['grad_norm']}")
        if on_card:
            for n, w in want.items():
                if rec["launches"][n] < w * (2 if step_fn is not step else 1):
                    bad.append(f"step {i + 1}: {n} launched {rec['launches'][n]} times")
        if any(c["cuda_calls"] != c["backward_recomputes"] for c in rec["plain"].values()):
            bad.append(f"step {i + 1}: a plain forward on the card: {rec['plain']}")
        log(f"train {cfg.name} step {json.dumps(rec)}")
        return st, met, rec

    for i in range(steps):
        state, _, rec = one(step, i)
        records.append(rec)
    after, trained_after = losses_at(HELD_OUT), losses_at(TRAINED)
    res = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "remat": cfg.remat, "batch": batch, "seq": seq,
           "loss_chunks": loss_chunks, "peak_lr": opt.peak_lr, "clip": opt.clip_norm,
           "params": sum(p.numel() for p in state.params.values()), "init_s": init_s,
           "losses": [r["loss"] for r in records],
           "grad_norms": [r["grad_norm"] for r in records],
           "held_out": {"batches": list(HELD_OUT), "before": before, "after": after},
           "trained": {"batches": list(TRAINED), "before": trained_before,
                       "after": trained_after},
           # the first step builds the workspace: the steady steps after it
           "ms_per_step": 1e3 * sum(r["s"] for r in records[1:]) / max(1, len(records) - 1),
           "max_memory_allocated": torch.cuda.max_memory_allocated() if on_card else None}
    res["tokens_per_s"] = batch * seq / (res["ms_per_step"] / 1e3)
    if not all(a < b for a, b in zip(after, before)):
        bad.append(f"the held-out loss did not fall: {before} before the steps, {after} after")
    if resume:
        step2 = make_train_step(lm, opt, microbatches=2, loss_chunks=loss_chunks)
        tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
        try:
            t0 = time.perf_counter()
            save_checkpoint(tmp, steps, state)
            save_s = time.perf_counter() - t0
            state, m_a, rec = one(step2, steps)
            t0 = time.perf_counter()
            _, restored = restore_checkpoint(tmp, _cpu_template(state))
            copy_state_(state, restored)
            del restored
            sync(device)
            restore_s = time.perf_counter() - t0
            state, m_b, rec2 = one(step2, steps)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        res["resume"] = {"save_s": save_s, "restore_s": restore_s, "loss": rec["loss"],
                         "loss_resumed": rec2["loss"], "ms": 1e3 * rec["s"],
                         "bit_identical": bool(torch.equal(m_a["loss"], m_b["loss"])),
                         "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                                  if on_card else None)}
        if not res["resume"]["bit_identical"]:
            bad.append(f"the resumed step's loss {rec2['loss']!r} is not {rec['loss']!r}")
    res["launches"] = launches
    del state, lm, step
    _free(device)
    log(f"train {cfg.name}: {json.dumps({k: v for k, v in res.items() if k != 'launches'})}")
    if bad:
        raise PhaseError(f"train {cfg.name} failed: " + "; ".join(bad))
    return res


def train_parity(device, cfg, *, batch: int = 1, seq: int = 256, loss_chunks: int = 4,
                 seed: int = 0) -> dict:
    """Phase 15 (c): one loss and gradient of ``cfg`` (fp32, cut in depth),
    the same weights and batch, on ``device`` (its kernels) and on the CPU
    (their plain versions): loss within 1e-4 relative, each gradient within
    1e-3 of its max|g|."""
    from repro_torch import kernels
    from repro_torch.data import SyntheticLM
    from repro_torch.models import LM
    from repro_torch.training import loss_and_grads, train_state_init

    lm_cpu = LM(cfg, seed=seed, device="cpu")
    lm = LM(cfg, seed=seed, device="cpu").to(device)
    b = SyntheticLM(cfg.vocab_size, batch, seq, seed=seed, device="cpu").batch_at(0)
    kernels.reset_launch_counts()
    loss, grads = loss_and_grads(lm, train_state_init(lm).params,
                                 {k: v.to(device) for k, v in b.items()}, loss_chunks=loss_chunks)
    sync(device)
    launches, plain = kernels.launch_counts(), kernels.plain_counts()
    loss_cpu, grads_cpu = loss_and_grads(lm_cpu, train_state_init(lm_cpu).params, b,
                                         loss_chunks=loss_chunks)
    worst, worst_name = 0.0, None
    for k, g in grads_cpu.items():
        e = float((grads[k].cpu() - g).abs().max()) / max(float(g.abs().max()), 1e-30)
        if not e <= worst:
            worst, worst_name = e, k
    res = {"arch": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype, "batch": batch,
           "seq": seq,
           "loss": float(loss), "loss_cpu": float(loss_cpu),
           "loss_rel": abs(float(loss) - float(loss_cpu)) / abs(float(loss_cpu)),
           "grad_worst": worst, "grad_worst_param": worst_name,
           "launches": {n: launches[n] for n in LM_KERNELS}, "plain": plain}
    del lm, grads, lm_cpu, grads_cpu
    _free(device)
    log(f"train parity: {json.dumps(res)}")
    bad = []
    if not res["loss_rel"] <= TRAIN_LOSS_RTOL:
        bad.append(f"loss {res['loss_rel']:.3e} relative > {TRAIN_LOSS_RTOL}")
    if not worst <= TRAIN_GRAD_TOL:
        bad.append(f"gradient {worst_name} {worst:.3e} of its max > {TRAIN_GRAD_TOL}")
    if torch.device(device).type == "cuda" and not any(res["launches"].values()):
        bad.append("no LM kernel launched")
    if bad:
        raise PhaseError(f"train parity {cfg.name} failed: " + "; ".join(bad))
    return res


def train(device, *, seed: int = 0, gemma=None, mamba=None, gemma_shape=(2, 2048),
          mamba_shape=(4, 2048), parity_layers: int = 2, parity_seq: int = 256,
          peak_lr: float | None = None) -> dict:
    """Phase 15: (a) gemma-2b at full width and depth, bf16, remat, 6 steps
    of 2 x 2 048 tokens and the resumed 7th (d); (b) mamba2-370m at full
    width and depth (48 layers, N = 128), 6 steps of 4 x 2 048 tokens; (c)
    one fp32 step of each cut to 2 layers, card against CPU. ``peak_lr``
    replaces both models' ``TRAIN_PEAK_LR``."""
    from repro_torch.configs import get_config

    gemma = gemma or get_config("gemma-2b")
    mamba = mamba or get_config("mamba2-370m")
    lrs = {c: peak_lr or TRAIN_PEAK_LR[c.name] for c in (gemma, mamba)}
    res = {"gemma": train_run(device, gemma, batch=gemma_shape[0], seq=gemma_shape[1],
                              peak_lr=lrs[gemma], resume=True, seed=seed),
           "mamba": train_run(device, mamba, batch=mamba_shape[0], seq=mamba_shape[1],
                              peak_lr=lrs[mamba], seed=seed)}
    res["parity"] = [train_parity(device, dataclasses.replace(c, n_layers=parity_layers,
                                                              dtype="float32"),
                                  seq=parity_seq, seed=seed) for c in (gemma, mamba)]
    res["launches"] = {n: res["gemma"]["launches"][n] + res["mamba"]["launches"][n]
                       for n in LM_KERNELS}
    return res


# ---------------------------------------------------------------------------
# 16. the launch package: the launcher killed and resumed, GPipe on the card
# ---------------------------------------------------------------------------

#: phase 16's model: the launcher and the pipeline run it at full width and
#: depth (48 layers, K9 in every one).
LAUNCH_ARCH = "mamba2-370m"
#: phase 16 (b): the pipeline's output and its stage params' gradients
#: against the same blocks run in sequence (tests/test_pipeline.py's
#: tolerances), relative to the largest value.
PIPE_OUT_TOL, PIPE_GRAD_TOL = 1e-5, 1e-4

_STEP_RE = re.compile(r"step (\d+) loss (\S+) lr (\S+) gnorm (\S+) launches (\{.*\})")


def _launcher_log(text: str) -> dict:
    """The launcher's log lines, parsed: per-step records, the restore, the
    checkpoints' times, the peak device memory and the ``done`` line."""
    steps = [{"step": int(m[1]), "loss": float(m[2]), "lr": float(m[3]),
              "grad_norm": float(m[4]), "launches": json.loads(m[5])}
             for m in _STEP_RE.finditer(text)]
    out = {"steps": steps, "restored": None, "restore_s": None, "checkpoints": [],
           "peak_bytes": None, "done": None, "ready_s": None}
    if m := re.search(r"ready to step in (\S+)s", text):
        out["ready_s"] = float(m[1])
    if m := re.search(r"restored checkpoint at step (\d+) in (\S+)s", text):
        out["restored"], out["restore_s"] = int(m[1]), float(m[2])
    if m := re.search(r"checkpoints: (\[.*\])", text):
        out["checkpoints"] = json.loads(m[1])
    if m := re.search(r"peak device memory: (\d+) B", text):
        out["peak_bytes"] = int(m[1])
    if m := re.search(r"done: (\S+)s, (\S+) tok/s, median step (\S+)s, (\d+) stragglers", text):
        out["done"] = {"s": float(m[1]), "tokens_per_s": float(m[2]),
                       "median_step_s": float(m[3]), "stragglers": int(m[4])}
    return out


def _same_checkpoint(a: pathlib.Path, b: pathlib.Path) -> tuple[int, list[str]]:
    """(leaves, keys whose stored bits differ) of two checkpoints."""
    import numpy as np

    ma = json.loads((a / "manifest.json").read_text())["leaves"]
    mb = json.loads((b / "manifest.json").read_text())["leaves"]
    differ = sorted(set(ma) ^ set(mb))
    for key in sorted(set(ma) & set(mb)):
        x, y = np.load(a / ma[key]["file"]), np.load(b / mb[key]["file"])
        if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
            differ.append(key)
    return len(ma), differ


def launcher_run(device, cfg, *, steps: int = 8, batch: int = 4, seq: int = 2048,
                 ckpt_every: int = 4, smoke: bool = False, timeout: float = 600.0) -> dict:
    """Phase 16 (a): ``python -m repro_torch.launch.train`` on ``cfg``, as a
    subprocess: once uninterrupted into D1; once into D2, SIGKILLed as soon
    as step ``ckpt_every``'s checkpoint has committed (its manifest is on
    disk), and relaunched with the same flags. Gates: the relaunch restores
    at step ``ckpt_every``; every logged step's loss and grad norm finite;
    on the card K9 (K8) launched in every Mamba (attention) layer of every
    forward (twice a step under remat: the backward recomputes each layer);
    the last checkpoints of D1 and D2 the same bits, every tensor of params
    and optimizer state. Beside them: the dry run's per-rank bytes of this
    cell on a mesh of one rank and the launcher's peak device memory."""
    import shutil
    import signal
    import tempfile

    from repro_torch.launch.dryrun import state_bytes
    from repro_torch.launch.specs import train_specs
    from repro_torch.models import LM
    from repro_torch.sharding import MeshCtx, MeshShape

    on_card = torch.device(device).type == "cuda"
    n_attn = sum(cfg.mixer_kind(i) == "attn" for i in range(cfg.n_layers))
    want = {"flash_attention": n_attn, "ssd": cfg.n_layers - n_attn}
    want = {k: v * (2 if cfg.remat else 1) for k, v in want.items() if v}
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_launch_"))
    bad, runs = [], {}

    def cmd(d):
        return ([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                 cfg.name.removesuffix("-smoke"), "--steps", str(steps), "--batch", str(batch),
                 "--seq", str(seq), "--ckpt-every", str(ckpt_every), "--ckpt-dir", str(d),
                 "--log-every", "1", "--device", str(device)] + (["--smoke"] if smoke else []))

    def run(name, d):
        t0 = time.perf_counter()
        out = subprocess.run(cmd(d), env=env, capture_output=True, text=True, timeout=timeout)
        runs[name] = {**_launcher_log(out.stderr + out.stdout), "rc": out.returncode,
                      "wall_s": time.perf_counter() - t0}
        if out.returncode != 0:
            raise PhaseError(f"launch: the {name} run exited {out.returncode}:\n"
                             f"{(out.stderr + out.stdout)[-3000:]}")

    try:
        d1, d2 = tmp / "D1", tmp / "D2"
        run("uninterrupted", d1)
        # drop D1's earlier checkpoints: only its last is compared
        for p in d1.glob("step_*"):
            if p.name != f"step_{steps:08d}":
                shutil.rmtree(p)
        t0 = time.perf_counter()
        with open(tmp / "killed.log", "w") as f:
            proc = subprocess.Popen(cmd(d2), env=env, stdout=f, stderr=subprocess.STDOUT)
            marker = d2 / f"step_{ckpt_every:08d}" / "manifest.json"
            while proc.poll() is None and not marker.exists():
                if time.perf_counter() - t0 > timeout:
                    proc.kill()
                    raise PhaseError(f"launch: no step-{ckpt_every} checkpoint in {timeout} s")
                time.sleep(0.02)
            proc.send_signal(signal.SIGKILL)
            proc.wait()
        killed = {**_launcher_log((tmp / "killed.log").read_text()), "rc": proc.returncode,
                  "wall_s": time.perf_counter() - t0,
                  "latest_at_kill": max((int(p.name[5:]) for p in d2.glob("step_*")
                                         if not p.name.endswith(".tmp")), default=None)}
        runs["killed"] = killed
        if proc.returncode != -signal.SIGKILL:
            bad.append(f"the second run ended with {proc.returncode}, not by SIGKILL")
        run("relaunched", d2)
        n_leaves, differ = _same_checkpoint(d1 / f"step_{steps:08d}", d2 / f"step_{steps:08d}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if runs["relaunched"]["restored"] != ckpt_every:
        bad.append(f"the relaunch restored step {runs['relaunched']['restored']}, "
                   f"not {ckpt_every}")
    launches = {n: 0 for n in LM_KERNELS}
    for name, r in runs.items():
        for rec in r["steps"]:
            if not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"])):
                bad.append(f"{name} step {rec['step']}: loss {rec['loss']}, "
                           f"grad_norm {rec['grad_norm']}")
            for n in LM_KERNELS:
                launches[n] += rec["launches"].get(n, 0)
            if on_card:
                for n, w in want.items():
                    if rec["launches"].get(n, 0) < w:
                        bad.append(f"{name} step {rec['step']}: {n} launched "
                                   f"{rec['launches'].get(n, 0)} times, not {w}")
    logged = [r["step"] for r in runs["uninterrupted"]["steps"]]
    if logged != list(range(1, steps + 1)):
        bad.append(f"the uninterrupted run logged steps {logged}")
    if [r["step"] for r in runs["relaunched"]["steps"]] != list(range(ckpt_every + 1, steps + 1)):
        bad.append(f"the relaunch logged steps {[r['step'] for r in runs['relaunched']['steps']]}")
    if differ:
        bad.append(f"D1 and D2's step-{steps} checkpoints differ in {len(differ)} of "
                   f"{n_leaves} leaves: {differ[:5]}")
    _, args = train_specs(cfg, batch, seq, MeshCtx(mesh=MeshShape(("data", "model"), (1, 1))))
    dry = state_bytes(args, "train")
    res = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "steps": steps, "batch": batch, "seq": seq, "ckpt_every": ckpt_every,
           "runs": {k: {kk: vv for kk, vv in v.items() if kk != "steps"} for k, v in runs.items()},
           "losses": [r["loss"] for r in runs["uninterrupted"]["steps"]],
           "losses_relaunched": [r["loss"] for r in runs["relaunched"]["steps"]],
           "leaves": n_leaves, "bit_identical": not differ,
           "dryrun_bytes_per_rank": {**dry, "total": sum(dry.values())},
           "launches": launches}
    log(f"launch (a) {cfg.name}: {json.dumps(res)}")
    if bad:
        raise PhaseError("launch (a) failed: " + "; ".join(bad))
    return res


def pipeline_config(**overrides):
    """Phase 16 (b)'s model: ``LAUNCH_ARCH`` in fp32 (the reference test's dtype)."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(LAUNCH_ARCH), dtype="float32", **overrides)


def _stage(blocks, h):
    """One pipeline stage: the blocks in order on one microbatch (B, S, d)."""
    positions = torch.arange(h.shape[1], device=h.device).expand(h.shape[0], h.shape[1])
    for blk in blocks:
        h = blk(h, positions, None)
    return h


def gpipe_rank(rank: int, world: int, tmp: str, device: str, backend: str,
               cfg_overrides: dict, seed: int) -> None:
    """One rank of phase 16 (b), in its own process (placed by
    ``rank_route``): the model from ``seed`` on ``device``, its stage's
    blocks (an equal share of the layers, in order), the pipelined forward
    and backward of loss = sum(out^2) under a ``CollectiveMeter``; writes
    ``tmp/rank<r>.pt``."""
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.launch.roofline import CollectiveMeter
    from repro_torch.models import LM
    from repro_torch.training import pipeline_apply

    rank_setup(rank, world, tmp, device, backend)
    try:
        cfg = pipeline_config(**cfg_overrides)
        per = cfg.n_layers // world
        lm = LM(cfg, seed=seed, device=device)
        blocks = lm.layers[rank * per:(rank + 1) * per].requires_grad_(True)
        x = torch.load(f"{tmp}/inputs.pt")["x"].to(device)
        run = pipeline_apply(_stage, world, x.shape[0], dist.group.WORLD)
        # a first step warms the process (cuBLAS, the plain backward's first
        # calls); the second, from zero gradients, is the one timed and read
        t0 = time.perf_counter()
        torch.sum(run(blocks, x) ** 2).backward()
        sync(device)
        first_s = time.perf_counter() - t0
        blocks.zero_grad(set_to_none=True)
        dist.barrier()
        kernels.reset_launch_counts()
        with CollectiveMeter() as meter:
            t0 = time.perf_counter()
            out = run(blocks, x)
            torch.sum(out ** 2).backward()
            sync(device)
            step_s = time.perf_counter() - t0
        torch.save({"out": out.detach().cpu(), "step_s": step_s, "first_s": first_s,
                    "grads": {k: p.grad.cpu() for k, p in blocks.named_parameters()},
                    "bytes": meter.bytes, "calls": meter.calls,
                    "launches": kernels.launch_counts(), "plain": kernels.plain_counts()},
                   f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def gpipe(device, *, world: int = 2, microbatches: int = 4, mb: tuple[int, int] = (1, 1024),
          seed: int = 0, cfg_overrides: dict | None = None, timeout: float = 600.0) -> dict:
    """Phase 16 (b): GPipe over ``world`` ranks (``run_ranks``: stage r on
    card r over NCCL where the machine has the cards, else sharing the one
    card over gloo), each holding an equal
    share of the model's blocks built from one seed; fp32, ``microbatches``
    microbatches of ``mb`` (B, S) tokens of ``SyntheticLM`` embeddings, loss
    = sum(out^2). Gates: the pipelined output within PIPE_OUT_TOL and each
    stage param's gradient within PIPE_GRAD_TOL, relative to the largest
    value, of the same blocks run in sequence, microbatch by microbatch, in
    this process; every rank's ``CollectiveMeter`` bytes the count from the
    shapes: (S + M - 1) activations sent forward and again backward
    (collective-permute) and one (M, B, S, d) buffer (all-reduce)."""
    import tempfile

    from repro_torch import kernels
    from repro_torch.data import SyntheticLM
    from repro_torch.models import LM

    cfg_overrides = cfg_overrides or {}
    cfg = pipeline_config(**cfg_overrides)
    if cfg.n_layers % world:
        raise PhaseError(f"gpipe: {cfg.n_layers} layers do not split into {world} stages")
    per = cfg.n_layers // world
    lm = LM(cfg, seed=seed, device=str(device))
    tokens = SyntheticLM(cfg.vocab_size, microbatches * mb[0], mb[1], seed=seed,
                         device=str(device)).batch_at(0)["tokens"]
    with torch.no_grad():
        x = lm.embed[tokens].reshape(microbatches, mb[0], mb[1], cfg.d_model)
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"x": x.cpu()}, f"{tmp}/inputs.pt")
        ranks, run = run_ranks("gpipe_rank", world, tmp, device, (cfg_overrides, seed),
                               phase="launch (b) gpipe", timeout=timeout)
    # the same blocks in sequence, microbatch by microbatch, in this process
    # (once to warm it, as the ranks do; the second pass is timed and read)
    lm.layers.requires_grad_(True)
    for _ in range(2):
        lm.layers.zero_grad(set_to_none=True)
        kernels.reset_launch_counts()
        sync(device)
        t0 = time.perf_counter()
        outs = []
        for i in range(microbatches):
            o = _stage(lm.layers, x[i])
            torch.sum(o ** 2).backward()
            outs.append(o.detach())
        sync(device)
        seq_s = time.perf_counter() - t0
    seq_launches = kernels.launch_counts()
    ref = torch.stack(outs).cpu()
    scale = float(ref.abs().max())
    out_err = max(float((r["out"] - ref).abs().max()) for r in ranks) / scale
    grad_worst, grad_name = 0.0, None
    for r, rk in enumerate(ranks):
        for k, g in rk["grads"].items():
            want = lm.layers[r * per + int(k.split(".")[0])].get_parameter(
                k.split(".", 1)[1]).grad.cpu()
            e = float((g - want).abs().max()) / max(float(want.abs().max()), 1e-30)
            if not e <= grad_worst:
                grad_worst, grad_name = e, f"layers.{r * per + int(k.split('.')[0])}." \
                                           f"{k.split('.', 1)[1]}"
    act = mb[0] * mb[1] * cfg.d_model * x.element_size()
    expect = {"collective-permute": 2 * (world + microbatches - 1) * act,
              "all-reduce": microbatches * act}
    res = {"arch": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype, **run,
           "microbatches": microbatches, "mb": list(mb),
           "step_s": [rk["step_s"] for rk in ranks],
           "first_step_s": [rk["first_s"] for rk in ranks], "sequential_s": seq_s,
           "out_err": out_err, "grad_worst": grad_worst, "grad_worst_param": grad_name,
           "bytes": [rk["bytes"] for rk in ranks], "expected_bytes": expect,
           "calls": [rk["calls"] for rk in ranks],
           "launches": {n: sum(rk["launches"][n] for rk in ranks) for n in LM_KERNELS},
           "rank_launches": [{n: rk["launches"][n] for n in LM_KERNELS} for rk in ranks],
           "sequential_launches": {n: seq_launches[n] for n in LM_KERNELS},
           "plain": [rk["plain"] for rk in ranks]}
    del lm, x, outs
    _free(device)
    log(f"launch (b) gpipe: {json.dumps(res)}")
    bad = []
    if not out_err <= PIPE_OUT_TOL:
        bad.append(f"output {out_err:.3e} of max|out| > {PIPE_OUT_TOL}")
    if not grad_worst <= PIPE_GRAD_TOL:
        bad.append(f"gradient {grad_name} {grad_worst:.3e} of its max > {PIPE_GRAD_TOL}")
    for r, rk in enumerate(ranks):
        got = {k: rk["bytes"][k] for k in expect}
        if got != expect or sum(rk["bytes"].values()) != sum(expect.values()):
            bad.append(f"rank {r}'s collective bytes {rk['bytes']} against {expect}")
    if torch.device(device).type == "cuda":
        n_mamba = sum(cfg.mixer_kind(i) == "mamba" for i in range(cfg.n_layers))
        # every step runs every block of the stage, bubble included
        per_rank = (world + microbatches - 1) * n_mamba // world
        for r, rl in enumerate(res["rank_launches"]):
            if rl["ssd"] < per_rank:
                bad.append(f"rank {r} launched K9 {rl['ssd']} times, not {per_rank}")
    if bad:
        raise PhaseError("launch (b) failed: " + "; ".join(bad))
    return res


def launch(device, *, seed: int = 0, cfg=None, steps: int = 2, batch: int = 4,
           seq: int = 2048, ckpt_every: int = 1, smoke: bool = False,
           pipe_mb: tuple[int, int] = (1, 1024), pipe_overrides: dict | None = None) -> dict:
    """Phase 16: (a) the launcher on ``cfg`` (mamba2-370m at full width and
    depth), killed after a checkpoint and relaunched; (b) GPipe over two
    ranks on the one card."""
    from repro_torch.configs import get_config

    if torch.device(device).type == "cuda":
        build_kernels()  # the launcher's and the ranks' processes load this build
    cfg = cfg or get_config(LAUNCH_ARCH)
    res = {"launcher": launcher_run(device, cfg, steps=steps, batch=batch, seq=seq,
                                    ckpt_every=ckpt_every, smoke=smoke),
           "gpipe": gpipe(device, mb=pipe_mb, seed=seed, cfg_overrides=pipe_overrides)}
    res["launches"] = {n: res["launcher"]["launches"][n] + res["gpipe"]["launches"][n]
                       for n in LM_KERNELS}
    return res


# ---------------------------------------------------------------------------
# 17. the LM sharded across ranks: FSDP over data, tensor parallelism over model
# ---------------------------------------------------------------------------

#: phase 17 (a): the launcher on this many ranks sharing the card (gloo),
#: ``--mesh local`` (every rank on ``data``).
SHARD_WORLD = 4
#: phase 17 (a): step 1's loss against the one-rank launcher's (phase 16), relative.
SHARD_LOSS_RTOL = 1e-3
#: phase 17 (b): the (data, model) mesh, and the reference's tolerances
#: (phase 15 (c)'s form): loss relative, each gradient over its max.
TP_MESH = (2, 2)
TP_LOSS_RTOL, TP_GRAD_TOL = 1e-5, 1e-4
#: phase 17 (b)'s models at full width: qwen3-32b cut to this many layers
#: (from 2, for the script's time limit), mamba2-370m at its full depth.
TP_DENSE_ARCH, TP_DENSE_LAYERS = "qwen3-32b", 1
#: phase 17 (b)'s models whose gradient gate is refereed: at mamba2-370m's
#: depth fp32's own rounding reaches past TP_GRAD_TOL of some leaves'
#: max|g| (at 48 layers), so there each leaf's distance from the unsharded step on the card
#: may exceed TP_GRAD_TOL by as much as the same unsharded step on the host
#: CPU (another order of every sum, K9's plain version) lies from it at its
#: worst leaf: the model's fp32 noise at that depth, measured in the run
#: (phases 4 and 12 gate an fp32 fit so against its fp64 referee).
TP_REFEREED = ("mamba2-370m",)
#: a gradient leaf 0 in exact arithmetic (the router at top_k = 1, whose one
#: choice's gate is renormalised to p / p = 1, ROADMAP C.1f) is held to 0 on
#: both sides to within this share of the model's largest gradient (each
#: side's fp32 rounding; tests/test_torch_sharded.py's ZERO_TOL).
TP_ZERO_TOL = 1e-6


def zero_grad_leaves(cfg) -> set:
    """The leaves whose gradient is 0 in exact arithmetic: every MoE layer's
    router at top_k = 1."""
    if not cfg.n_experts or cfg.top_k != 1:
        return set()
    return {f"layers.{i}.moe.router" for i in range(cfg.n_layers) if cfg.mlp_kind(i) == "moe"}


def shard_step_bytes(cfg, dp: int, mp: int, rows: int, seq: int, loss_chunks: int, *,
                     norm: bool = True) -> dict:
    """Per-rank bytes of one sharded train step's collectives on a (data =
    ``dp``, model = ``mp``) mesh, ``rows`` x ``seq`` tokens on the rank, in
    ``CollectiveMeter``'s terms: the closed form of ``sharding.collectives``'
    scheme (PERF.md section 6).

    Per forward of a leaf split over ``data``: a gather, an all-to-all whose
    output is ``dp`` blocks in the param dtype, and in the backward one fp32
    reduce-scatter, an all-to-all of ``dp`` blocks too; the same over
    ``model`` where the model gathers there too (attention's k/v when the
    kv heads do not divide over ``model``; Mamba-2's ``in_proj`` and
    conv). Over ``model`` (mp > 1),
    fp32 all-reduces of the (rows, seq, d) hidden state: one forward after
    each row-parallel product, one backward at each column-parallel input
    (the embedding lookup, the head's input), Mamba-2's gated norm two of
    (rows, seq), its per-head vectors and norm gain one each, qk-norm gains
    one each, and per loss chunk three of its (rows, chunk) statistics. Under
    remat each layer's forward runs twice, its trailing all-reduce once (the
    recompute stops at the last tensor the backward needs), and each loss
    chunk twice. A MoE layer split over ``model`` (``ep``: experts,
    ``tp``: each expert's ff columns; ``cfg.moe_mode(TP)``) gathers
    its rank's block of each expert leaf over ``data`` and adds one
    forward all-reduce of the partial combines and, backward, one of its
    input's gradient and one of the fp32 router's (d, E); a ``replicate``
    MoE gathers whole experts over ``data`` and adds nothing over
    ``model``, and without a shared expert its layer ends in no
    all-reduce (the recompute runs through the mixer's). Over ``data``
    (dp > 1): the loss (4 B) and one all-reduce of
    every leaf not split over ``data`` (its gradient). The norm (``norm``:
    a train step's; ``loss_and_grads`` takes none): one all-reduce per
    split axis of a float per group of leaves split alike."""
    from repro_torch.models import LM
    from repro_torch.models.config import TP
    from repro_torch.models.model import padded_vocab
    from repro_torch.sharding import MeshCtx, MeshShape, logical_to_spec

    it = 2 if cfg.dtype == "bfloat16" else 4
    d, tok = cfg.d_model, rows * seq
    act = 4 * tok * d
    out = {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0, "all-to-all": 0}

    def up(n, k):
        return -(-n // k)

    def gather(shape, data_dim, model_dim, model_too=False, times=1):
        local = [up(n, dp) if i == data_dim else up(n, mp) if i == model_dim else n
                 for i, n in enumerate(shape)]
        if dp > 1 and data_dim is not None:
            out["all-to-all"] += dp * math.prod(local) * (times * it + 4)
        if model_too and mp > 1:
            full = [up(n, mp) if i == model_dim else n for i, n in enumerate(shape)]
            out["all-to-all"] += mp * math.prod(full) * (times * it + 4)

    times = 2 if cfg.remat else 1
    for i in range(cfg.n_layers):
        if cfg.mixer_kind(i) == "attn":
            hq, hkv, hd = cfg.padded_heads(TP), cfg.padded_kv_heads(TP), cfg.head_dim
            gather((d, hq * hd), 0, 1, times=times)
            for _ in range(2):
                gather((d, hkv * hd), 0, 1, hkv % mp != 0, times)
            gather((hq * hd, d), 1, 0, times=times)
            if mp > 1:
                out["all-reduce"] += times * act + act + (2 * hd * 4 if cfg.qk_norm else 0)
        else:
            di, ns, nh, k = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
            gather((d, 2 * di + 2 * ns + nh), 0, 1, True, times)
            gather((k, di + 2 * ns), None, 1, True, times)
            gather((di, d), 1, 0, times=times)
            if mp > 1:
                out["all-reduce"] += (times * (act + 4 * tok) + act + 4 * tok
                                      + 4 * (3 * nh + di))
        kind = cfg.mlp_kind(i)
        gated = cfg.mlp_act in ("swiglu", "geglu")
        if kind == "dense" or (kind == "moe" and cfg.shared_expert_ff):
            ff = cfg.d_ff if kind == "dense" else cfg.shared_expert_ff
            for _ in range(2 if gated else 1):
                gather((d, ff), 0, 1, times=times)
            gather((ff, d), 1, 0, times=times)
            if mp > 1:
                out["all-reduce"] += times * act + act
        split = kind == "moe" and cfg.moe_mode(TP) != "replicate"
        if kind == "moe":
            e, ff = cfg.n_experts, cfg.d_ff
            up_dim, down_dim = {"ep": (0, 0), "tp": (2, 1)}.get(cfg.moe_mode(TP),
                                                                 (None, None))
            for _ in range(2 if gated else 1):
                gather((e, d, ff), 1, up_dim, times=times)
            gather((e, ff, d), 2, down_dim, times=times)
            if split and mp > 1:  # the partial combines, the input's and the router's gradients
                out["all-reduce"] += times * act + act + 4 * d * e
        if cfg.remat and mp > 1 and (kind != "moe" or split or cfg.shared_expert_ff):
            out["all-reduce"] -= act  # the layer's last all-reduce is not recomputed
    vp = padded_vocab(cfg)
    if cfg.embed_inputs:
        gather((vp, d), 1, 0)
        if mp > 1:
            out["all-reduce"] += act
    if cfg.tie_embeddings:
        gather((vp, d), 1, 0)
    else:
        gather((d, vp), 0, 1)
    if mp > 1:
        out["all-reduce"] += act + 2 * 12 * tok
    # the loss, the replicated leaves' gradients, the norm
    ctx = MeshCtx(mesh=MeshShape(("data", "model"), (dp, mp)))
    lm = LM(cfg, device="meta")
    sizes = {"data": dp, "model": mp}
    keys, replicated = set(), 0
    for name, t in lm.state_dict().items():
        spec = logical_to_spec(*lm.logical[name], ctx=ctx)
        axes = [e if isinstance(e, str) else None for e in spec] + [None] * (t.ndim - len(spec))
        local = math.prod(up(n, sizes[a]) if a else n for n, a in zip(t.shape, axes))
        keys.add(tuple(a for a in ("data", "model") if a in axes and sizes[a] > 1))
        if "data" not in axes:
            replicated += local
    if dp > 1:
        out["all-reduce"] += 4 + 4 * replicated
    for a in ("data", "model"):
        if norm and sizes[a] > 1 and any(a in k for k in keys):
            out["all-reduce"] += 4 * len(keys)
    return out


def decode_step_bytes(cfg, dp: int, mp: int, batch: int, max_len: int, layout: str) -> dict:
    """Per-rank bytes of one ``LM.decode_step``'s collectives under
    ``sharding.serve_ctx``'s layout on a (data = ``dp``, model = ``mp``)
    mesh, in ``CollectiveMeter``'s terms: ``layout`` "seq_model" (the
    ``batch`` over ``data``, the cache's sequence over ``model``) or
    "seq_shard_wide" (one sequence, its cache over ``data`` x ``model``).
    The closed form of the scheme (PERF.md section 6); ``max_len`` moves
    no byte (each rank attends over its block where it lies).

    Parameters are replicated over ``data`` (no FSDP gathers). Over
    ``model`` (mp > 1), gathers of activations (all-to-alls whose output
    is ``mp`` blocks in the model's dtype): per attention layer the new
    token's q, k and v columns (one collective); per Mamba-2 layer its
    [z | x B C | dt] projection with the conv window's k - 1 rows of
    history (one), and the conv weight (k, conv_dim). fp32 all-reduces of the (rows, d) hidden state:
    the embedding lookup, every row-parallel product (attention's ``wo``,
    Mamba-2's ``out_proj``, the MLP, a MoE split over ``model`` and its
    shared expert), plus Mamba-2's gated norm's (rows, 1). The attention's
    merge: the fp32 partials (acc, max, sum: head_dim + 2 a head) of this
    rank's heads from every rank of the sequence's axes, an all-to-all
    over ``model`` when the sequence is split there, then a gather over
    ``data`` of the ``model`` ranks' pieces (seq_shard_wide)."""
    from repro_torch.models.config import TP

    if layout not in ("seq_model", "seq_shard_wide"):
        raise ValueError(f"layout {layout!r}")
    wide = layout == "seq_shard_wide"
    if wide and batch != 1:
        raise ValueError("seq_shard_wide serves one sequence")
    if batch % (1 if wide else dp) or max_len % (dp * mp if wide else mp):
        raise ValueError(f"{batch} x {max_len} does not split over ({dp}, {mp})")
    it = 2 if cfg.dtype == "bfloat16" else 4
    rows = batch if wide else batch // dp
    d = cfg.d_model
    ar = 4 * rows * d
    out = {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0, "all-to-all": 0}

    def up(n, k):
        return -(-n // k)

    def gather(*shape):  # over model: mp blocks of the last dimension's ceiling piece
        if mp > 1:
            out["all-to-all"] += mp * math.prod(shape[:-1]) * up(shape[-1], mp) * it

    if mp > 1:
        out["all-reduce"] += ar  # the embedding lookup
    for i in range(cfg.n_layers):
        if cfg.mixer_kind(i) == "attn":
            hq, hkv, hd = cfg.padded_heads(TP), cfg.padded_kv_heads(TP), cfg.head_dim
            gather(rows, hq * hd)
            gather(rows, hkv * hd)
            gather(rows, hkv * hd)
            part = 4 * rows * (hq // mp) * (hd + 2)  # one rank's partials of a rank's heads
            if mp > 1:
                out["all-to-all"] += mp * part
                out["all-reduce"] += ar
            if wide and dp > 1:
                out["all-to-all"] += dp * mp * part
        else:
            di, ns, nh, k = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
            gather(rows, 2 * di + 2 * ns + nh)
            gather(rows, k - 1, di + 2 * ns)
            gather(k, di + 2 * ns)
            if mp > 1:
                out["all-reduce"] += ar + 4 * rows
        kind = cfg.mlp_kind(i)
        if mp > 1 and (kind == "dense"
                       or (kind == "moe" and cfg.moe_mode(TP) != "replicate")):
            out["all-reduce"] += ar
        if mp > 1 and kind == "moe" and cfg.shared_expert_ff:
            out["all-reduce"] += ar
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _kill_tree(pid: int) -> None:
    """SIGKILL ``pid`` and every process under it (torchrun starts each rank
    in a session of its own, so its process group does not reach them)."""
    import signal

    children: dict[int, list[int]] = {}
    for stat in pathlib.Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        children.setdefault(int(fields[1]), []).append(int(stat.parent.name))
    tree, todo = [], [pid]
    while todo:
        p = todo.pop()
        tree.append(p)
        todo.extend(children.get(p, []))
    for p in reversed(tree):  # the ranks first, then the agent
        try:
            os.kill(p, signal.SIGKILL)
        except ProcessLookupError:
            pass


def _rank_logs(text: str) -> dict:
    """The sharded launcher's own lines: each rank's launches per logged
    step, and each rank's state bytes and peak device memory."""
    out = {"rank_launches": {}, "ranks": None}
    for m in re.finditer(r"step (\d+) rank launches (\[.*\])", text):
        out["rank_launches"][int(m[1])] = json.loads(m[2])
    if m := re.search(r"per-rank: (\[.*\])", text):
        out["ranks"] = json.loads(m[1])
    return out


def shard_launcher(device, cfg, *, world: int = SHARD_WORLD, steps: int = 8, batch: int = 4,
                   seq: int = 2048, ckpt_every: int = 4, smoke: bool = False,
                   one_rank_loss: float | None = None, timeout: float = 900.0) -> dict:
    """Phase 17 (a): ``torchrun --nproc-per-node world -m
    repro_torch.launch.train --mesh local`` on ``cfg`` (every rank on
    ``data``; one rank a card over NCCL where the machine has the cards,
    else gloo on one card), as a user runs it: once uninterrupted into
    D1; once into D2, SIGKILLed (torchrun and its ranks, one process group)
    as soon as step ``ckpt_every``'s checkpoint has committed, and
    relaunched. Gates: the relaunch restores at ``ckpt_every``; every step's
    loss and grad norm finite; the step-``steps`` checkpoints of D1 and D2
    the same bits in every leaf; step 1's loss within SHARD_LOSS_RTOL of the
    one-rank launcher's (``one_rank_loss``: phase 16's; without it a
    one-rank launcher runs one step here); each rank's state bytes the dry
    run's for ``MeshShape(("data", "model"), (world, 1))``; on the card each
    rank's peak while its params are drawn at most its blocks and one whole
    leaf's draw, and K9 (K8) launched twice per Mamba (attention) layer and
    step on every rank."""
    import shutil
    import signal
    import tempfile

    from repro_torch.launch.dryrun import state_bytes
    from repro_torch.launch.specs import train_specs
    from repro_torch.models import LM
    from repro_torch.sharding import MeshCtx, MeshShape

    on_card = torch.device(device).type == "cuda"
    n_attn = sum(cfg.mixer_kind(i) == "attn" for i in range(cfg.n_layers))
    want = {"flash_attention": n_attn, "ssd": cfg.n_layers - n_attn}
    want = {k: v * (2 if cfg.remat else 1) for k, v in want.items() if v}
    threads = max(1, (os.cpu_count() or world) // world)
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": str(threads)}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_shard_"))
    args = ["--arch", cfg.name.removesuffix("-smoke"), "--steps", str(steps), "--batch",
            str(batch), "--seq", str(seq), "--ckpt-every", str(ckpt_every), "--log-every", "1",
            "--device", str(device)] + (["--smoke"] if smoke else [])
    bad, runs = [], {}

    def cmd(d):
        return ([sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(world),
                 "--master-addr", "127.0.0.1", "--master-port", str(_free_port()),
                 "-m", "repro_torch.launch.train", "--mesh", "local", "--ckpt-dir", str(d)]
                + args)

    def parse(text):
        return {**_launcher_log(text), **_rank_logs(text)}

    def run(name, d):
        t0 = time.perf_counter()
        out = subprocess.run(cmd(d), env=env, capture_output=True, text=True, timeout=timeout,
                             start_new_session=True)
        runs[name] = {**parse(out.stderr + out.stdout), "rc": out.returncode,
                      "wall_s": time.perf_counter() - t0}
        if out.returncode != 0:
            raise PhaseError(f"shard: the {name} launcher run exited {out.returncode}:\n"
                             f"{(out.stderr + out.stdout)[-3000:]}")

    try:
        if one_rank_loss is None:
            t0 = time.perf_counter()
            one = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--steps",
                                  "1"] + args[2:] + ["--arch", args[1]], env=env,
                                 capture_output=True, text=True, timeout=timeout)
            if one.returncode != 0:
                raise PhaseError(f"shard: the one-rank launcher exited {one.returncode}:\n"
                                 f"{(one.stderr + one.stdout)[-3000:]}")
            one_rank_loss = _launcher_log(one.stderr + one.stdout)["steps"][0]["loss"]
            runs["one_rank"] = {"wall_s": time.perf_counter() - t0}
        d1, d2 = tmp / "D1", tmp / "D2"
        run("uninterrupted", d1)
        for p in d1.glob("step_*"):
            if p.name != f"step_{steps:08d}":
                shutil.rmtree(p)
        t0 = time.perf_counter()
        with open(tmp / "killed.log", "w") as f:
            proc = subprocess.Popen(cmd(d2), env=env, stdout=f, stderr=subprocess.STDOUT,
                                    start_new_session=True)
            marker = d2 / f"step_{ckpt_every:08d}" / "manifest.json"
            try:
                while proc.poll() is None and not marker.exists():
                    if time.perf_counter() - t0 > timeout:
                        raise PhaseError(f"shard: no step-{ckpt_every} checkpoint in {timeout} s")
                    time.sleep(0.02)
            finally:
                _kill_tree(proc.pid)  # torchrun and every rank
                proc.wait()
        killed_at = max((int(p.name[5:]) for p in d2.glob("step_*")
                         if not p.name.endswith(".tmp")), default=None)
        runs["killed"] = {**parse((tmp / "killed.log").read_text()), "rc": proc.returncode,
                          "wall_s": time.perf_counter() - t0, "latest_at_kill": killed_at}
        if proc.returncode != -signal.SIGKILL:
            bad.append(f"the second run ended with {proc.returncode}, not by SIGKILL")
        run("relaunched", d2)
        n_leaves, differ = _same_checkpoint(d1 / f"step_{steps:08d}", d2 / f"step_{steps:08d}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if runs["relaunched"]["restored"] != ckpt_every:
        bad.append(f"the relaunch restored step {runs['relaunched']['restored']}, "
                   f"not {ckpt_every}")
    launches = {n: 0 for n in LM_KERNELS}
    for name in ("uninterrupted", "killed", "relaunched"):
        r = runs[name]
        for rec in r["steps"]:
            if not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"])):
                bad.append(f"{name} step {rec['step']}: loss {rec['loss']}, "
                           f"grad_norm {rec['grad_norm']}")
        for step, ranks in r["rank_launches"].items():
            if len(ranks) != world:
                bad.append(f"{name} step {step}: launches of {len(ranks)} ranks, not {world}")
            for k, rl in enumerate(ranks):
                for n in LM_KERNELS:
                    launches[n] += rl.get(n, 0)
                if on_card:
                    for n, w in want.items():
                        if rl.get(n, 0) != w:
                            bad.append(f"{name} step {step} rank {k}: {n} launched "
                                       f"{rl.get(n, 0)} times, not {w}")
    logged = [r["step"] for r in runs["uninterrupted"]["steps"]]
    if logged != list(range(1, steps + 1)) or \
            sorted(runs["uninterrupted"]["rank_launches"]) != logged:
        bad.append(f"the uninterrupted run logged steps {logged}")
    if [r["step"] for r in runs["relaunched"]["steps"]] != list(range(ckpt_every + 1, steps + 1)):
        bad.append(f"the relaunch logged steps {[r['step'] for r in runs['relaunched']['steps']]}")
    if differ:
        bad.append(f"D1 and D2's step-{steps} checkpoints differ in {len(differ)} of "
                   f"{n_leaves} leaves: {differ[:5]}")
    loss1 = runs["uninterrupted"]["steps"][0]["loss"] if logged else float("nan")
    loss_rel = abs(loss1 - one_rank_loss) / abs(one_rank_loss)
    if not loss_rel <= SHARD_LOSS_RTOL:
        bad.append(f"step 1's loss {loss1} against the one-rank launcher's {one_rank_loss}: "
                   f"{loss_rel:.3e} relative > {SHARD_LOSS_RTOL}")
    _, sargs = train_specs(cfg, batch, seq,
                           MeshCtx(mesh=MeshShape(("data", "model"), (world, 1))))
    dry = state_bytes(sargs, "train")
    ranks = runs["uninterrupted"]["ranks"] or []
    if [r["state_bytes"] for r in ranks] != [dry["params"] + dry["opt"]] * world:
        bad.append(f"per-rank state bytes {[r['state_bytes'] for r in ranks]} against the dry "
                   f"run's {dry['params'] + dry['opt']}")
    # the params drawn leaf by leaf: the rank's blocks and one whole leaf's
    # draw (ninit: two fp32 copies) at once, and a little for the generator
    biggest = max(p.numel() for p in LM(cfg, device="meta").parameters())
    init_bound = dry["params"] + 8 * biggest + 2 ** 26
    if on_card and not all(r["init_peak_bytes"] <= init_bound for r in ranks):
        bad.append(f"peak bytes while drawing the params {[r['init_peak_bytes'] for r in ranks]}"
                   f" > {init_bound} (the blocks and one whole leaf)")
    done = runs["uninterrupted"]["done"] or {}
    # the launcher's own rule (launch.mesh.backend_for) is rank_route's
    res = {"arch": cfg.name, "n_layers": cfg.n_layers, "world": world,
           "route": route_name(rank_route(0, world, device, cards_of(device))[1]),
           "steps": steps, "batch": batch, "seq": seq, "ckpt_every": ckpt_every,
           "runs": {k: {kk: vv for kk, vv in v.items() if kk not in ("steps", "rank_launches")}
                    for k, v in runs.items()},
           "losses": [r["loss"] for r in runs["uninterrupted"]["steps"]],
           "losses_relaunched": [r["loss"] for r in runs["relaunched"]["steps"]],
           "one_rank_loss": one_rank_loss, "loss_rel": loss_rel,
           "leaves": n_leaves, "bit_identical": not differ,
           "dryrun_bytes_per_rank": {**dry, "total": sum(dry.values())},
           "rank_state_bytes": [r["state_bytes"] for r in ranks],
           "rank_peak_bytes": [r["peak_bytes"] for r in ranks],
           "rank_init_peak_bytes": [r["init_peak_bytes"] for r in ranks],
           "init_peak_bound": init_bound,
           "tokens_per_s": done.get("tokens_per_s"), "median_step_s": done.get("median_step_s"),
           "launches": launches}
    log(f"shard (a) {cfg.name} on {world} ranks: {json.dumps(res)}")
    if bad:
        raise PhaseError("shard (a) failed: " + "; ".join(bad))
    return res


def tp_config(arch: str, **overrides):
    """Phase 17 (b)'s and 18's models, in fp32 at full width: qwen3-32b cut
    to ``TP_DENSE_LAYERS`` layers, mamba2-370m at its full depth, any other
    as ``overrides`` cut it (phase 18: ``MOE_SHARD``)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch == TP_DENSE_ARCH:
        overrides = {"n_layers": TP_DENSE_LAYERS, **overrides}
    return dataclasses.replace(cfg, dtype="float32", **overrides)


def _tp_opt():
    from repro_torch.optim import OptConfig

    return OptConfig(peak_lr=1e-3, warmup=1, total_steps=10)


def _grads_from_mu(opt: dict, grad_norm: float, clip: float, b1: float) -> dict:
    """The gradients of a first AdamW step from its moments: mu = (1 - b1)
    g min(1, clip / |g|)."""
    scale = min(1.0, clip / max(grad_norm, 1e-9))
    return {k: v / ((1 - b1) * scale) for k, v in opt["mu"].items()}


@contextlib.contextmanager
def moe_drops():
    """Within the block, every MoE call's routing observed: the yielded
    list gets, per call, each row's dropped choices (``route_group``'s
    slots at the discard row E * C) and the call's number of choices.
    ``MoE.forward`` looks ``route_group`` up at call time; the module's
    own function is back on exit, whatever the block raised."""
    import repro_torch.models.moe as moe

    route, calls = moe.route_group, []

    def counted(x, router, top_k, cap, n_experts):
        slot, gate = route(x, router, top_k, cap, n_experts)
        calls.append(((slot == n_experts * cap).sum(dim=1).tolist(), slot.numel()))
        return slot, gate

    moe.route_group = counted
    try:
        yield calls
    finally:
        moe.route_group = route


def tp_rank(rank: int, world: int, tmp: str, device: str, backend: str, arch: str,
            overrides: dict, mesh: tuple[int, int], rows: int, seq: int, chunks: int,
            seed: int, adamw: bool = True) -> None:
    """One rank of phase 17 (b) and 18, in its own process (placed by
    ``rank_route``): a (data, model) ``DeviceMesh``, the params' blocks of
    the seed's model drawn leaf by leaf (``models.init_blocks``, as the
    launcher does), its rows of the batch, one step of ``make_train_step``
    (``adamw``; else ``loss_and_grads``, no optimizer state) under a
    ``CollectiveMeter``; writes ``tmp/rank<r>.pt`` (the step's loss, norm,
    bytes, launches, the MoE layers' dropped and routed choices, and its
    blocks of the gradient, from AdamW's mu where it ran)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import kernels
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.roofline import CollectiveMeter
    from repro_torch.models import LM, init_blocks, param_specs
    from repro_torch.optim import adamw_init
    from repro_torch.sharding import MeshCtx, collectives, mesh_coords, set_mesh_ctx
    from repro_torch.training import TrainState, loss_and_grads, make_train_step

    on_card = rank_setup(rank, world, tmp, device, backend)
    try:
        cfg = tp_config(arch, **overrides)
        dmesh = init_device_mesh(torch.device(device).type, mesh,
                                 mesh_dim_names=("data", "model"))
        ctx = MeshCtx(mesh=dmesh)
        set_mesh_ctx(ctx)
        plan = collectives.active()
        pspecs = param_specs(cfg, ctx)
        t0 = time.perf_counter()
        params = {k: v.requires_grad_(True) for k, v in
                  init_blocks(cfg, pspecs, dmesh, seed=seed, device=device).items()}
        sync(device)
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated() if on_card else None
        batch = SyntheticLM(cfg.vocab_size, rows * mesh[0], seq, seed=seed, device=device,
                            shard=(plan.batch_index, plan.batch_ways)).batch_at(0)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        kernels.reset_launch_counts()
        if adamw:
            state = TrainState(params, adamw_init(params))
            step = make_train_step(cfg, _tp_opt(), loss_chunks=chunks)
            with CollectiveMeter() as meter, moe_drops() as drops:
                t0 = time.perf_counter()
                state, m = step(state, batch)
                sync(device)
                step_s = time.perf_counter() - t0
            loss, norm = float(m["loss"]), float(m["grad_norm"])
            opt = _tp_opt()
            grads = _grads_from_mu(state.opt, norm, opt.clip_norm, opt.b1)
        else:
            with CollectiveMeter() as meter, moe_drops() as drops:
                t0 = time.perf_counter()
                loss, grads = loss_and_grads(LM(cfg, device="meta"), params, batch,
                                             loss_chunks=chunks)
                sync(device)
                step_s = time.perf_counter() - t0
            loss, norm = float(loss), None
        routed = [sum(map(sum, (d for d, _ in drops))), sum(n for _, n in drops)]
        torch.save({"loss": loss, "grad_norm": norm, "routed": routed,
                    "coords": mesh_coords(dmesh), "grads": {k: v.cpu() for k, v in grads.items()},
                    "bytes": meter.bytes, "calls": meter.calls, "step_s": step_s,
                    "init_s": init_s, "init_peak_bytes": init_peak,
                    "launches": kernels.launch_counts(),
                    "peak_bytes": torch.cuda.max_memory_allocated() if on_card else None},
                   f"{tmp}/rank{rank}.pt")
    finally:
        set_mesh_ctx(None)
        dist.destroy_process_group()


def _tp_grads(cfg, params: dict, batch: dict, chunks: int,
              adamw: bool = True) -> tuple[float, dict, float]:
    """(loss, gradients, seconds) of one unsharded ``make_train_step`` on
    ``params`` (updated in place), the gradients from AdamW's first mu; or,
    without ``adamw``, of ``loss_and_grads``."""
    from repro_torch.models import LM
    from repro_torch.optim import adamw_init
    from repro_torch.training import TrainState, loss_and_grads, make_train_step

    device = next(iter(params.values())).device
    if not adamw:
        sync(device)
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(LM(cfg, device="meta"), params, batch, loss_chunks=chunks)
        sync(device)
        return float(loss), grads, time.perf_counter() - t0
    state = TrainState(params, adamw_init(params))
    sync(device)
    t0 = time.perf_counter()
    state, m = make_train_step(cfg, _tp_opt(), loss_chunks=chunks)(state, batch)
    sync(device)
    seconds = time.perf_counter() - t0
    opt = _tp_opt()
    return (float(m["loss"]), _grads_from_mu(state.opt, float(m["grad_norm"]), opt.clip_norm,
                                             opt.b1), seconds)


def _leaf_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| over max|want|."""
    return float((got.float() - want.float()).abs().max()) / max(float(want.abs().max()), 1e-30)


def tensor_parallel(device, arch: str, *, mesh: tuple[int, int] = TP_MESH, rows: int = 1,
                    seq: int = 512, chunks: int = 4, seed: int = 0,
                    overrides: dict | None = None, timeout: float = 900.0,
                    adamw: bool = True, phase: str = "shard (b)") -> dict:
    """Phase 17 (b): one fp32 step of ``make_train_step`` on ``tp_config(arch)``
    over a (data, model) = ``mesh`` of ranks (``run_ranks``: one a card over
    NCCL where the machine has the cards, else sharing the card over gloo),
    each with ``rows`` rows of ``seq`` tokens
    and its blocks of the seed's model; then the same step unsharded on the
    card in this process, once the ranks have exited, and for an ``arch``
    in TP_REFEREED on the host CPU from the card's weights. Gates: the loss
    within TP_LOSS_RTOL; every gradient (each rank's blocks against the
    unsharded one's, recovered from AdamW's first mu on both sides) within
    TP_GRAD_TOL of its max, plus, where refereed, the CPU step's largest
    such distance from the card's over all leaves (a leaf 0 in exact
    arithmetic, ``zero_grad_leaves``, within TP_ZERO_TOL of the model's
    largest gradient on both sides); each rank's
    ``CollectiveMeter`` bytes
    ``shard_step_bytes``; on the card K8 and K9 launched in every layer on
    every rank (twice under remat). Without ``adamw`` (phase 18) the step
    is ``loss_and_grads`` on both sides: no optimizer state, no norm."""
    import tempfile

    from repro_torch import kernels
    from repro_torch.data import SyntheticLM
    from repro_torch.models import LM, param_specs
    from repro_torch.models.config import TP
    from repro_torch.sharding import MeshCtx, MeshShape, block

    overrides = overrides or {}
    cfg = tp_config(arch, **overrides)
    world = mesh[0] * mesh[1]
    on_card = torch.device(device).type == "cuda"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        ranks, run = run_ranks("tp_rank", world, tmp, device,
                               (arch, overrides, tuple(mesh), rows, seq, chunks, seed, adamw),
                               phase=f"{phase} {cfg.name}", timeout=timeout)
    # the same step unsharded on the card, from the same seed
    lm = LM(cfg, seed=seed, device=str(device))
    params = {k: p.detach().requires_grad_(True) for k, p in lm.named_parameters()}
    del lm
    host = ({k: p.detach().to("cpu", copy=True).requires_grad_(True)
             for k, p in params.items()} if arch in TP_REFEREED else None)
    batch = SyntheticLM(cfg.vocab_size, rows * mesh[0], seq, seed=seed,
                        device=str(device)).batch_at(0)
    kernels.reset_launch_counts()
    loss, ref, ref_s = _tp_grads(cfg, params, batch, chunks, adamw)
    del params
    noise, cpu_s, zero = {}, None, zero_grad_leaves(cfg)
    if host is not None:  # the referee: the same step on the host CPU
        threads = torch.get_num_threads()
        torch.set_num_threads(os.cpu_count() or threads)
        try:
            _, grads, cpu_s = _tp_grads(cfg, host, {k: v.cpu() for k, v in batch.items()},
                                        chunks, adamw)
        finally:
            torch.set_num_threads(threads)
        noise = {k: _leaf_err(g, ref[k].cpu()) for k, g in grads.items() if k not in zero}
        del host, grads
    shape = MeshShape(("data", "model"), tuple(mesh))
    specs = param_specs(cfg, MeshCtx(mesh=shape))
    noise_worst = max(noise.items(), key=lambda kv: kv[1], default=(None, 0.0))
    bound = TP_GRAD_TOL + noise_worst[1]
    worst, worst_name, over, zeros = 0.0, None, [], {}
    top = max(float(g.abs().max()) for g in ref.values())
    for k, g in ref.items():
        if k in zero:  # both sides 0 to within their rounding
            zeros[k] = max([float(g.abs().max())]
                           + [float(rk["grads"][k].abs().max()) for rk in ranks]) / top
            if not zeros[k] <= TP_ZERO_TOL:
                over.append(f"{k} (0 in exact arithmetic) {zeros[k]:.3e} of the largest")
            continue
        e = max(_leaf_err(rk["grads"][k], block(g, specs[k], shape, rk["coords"]).cpu())
                for rk in ranks)
        if not e <= worst:
            worst, worst_name = e, k
        if not e <= bound:
            over.append(f"{k} {e:.3e}")
    del ref
    _free(device)
    loss_rel = max(abs(rk["loss"] - loss) for rk in ranks) / abs(loss)
    expect = shard_step_bytes(cfg, mesh[0], mesh[1], rows, seq, chunks, norm=adamw)
    res = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "mesh": list(mesh), "rows_per_rank": rows, "seq": seq, "loss": loss,
           "loss_rel": loss_rel, "grad_worst": worst, "grad_worst_param": worst_name,
           "referee_worst": noise_worst[1] if noise else None,
           "referee_worst_param": noise_worst[0], "grad_bound": bound,
           "referee_at_grad_worst": noise.get(worst_name), "zero_leaves": zeros, "over": over,
           **run, "step_s": [rk["step_s"] for rk in ranks],
           "init_s": [rk["init_s"] for rk in ranks], "unsharded_step_s": ref_s,
           "cpu_step_s": cpu_s, "bytes": [rk["bytes"] for rk in ranks], "expected_bytes": expect,
           "calls": [rk["calls"] for rk in ranks],
           "rank_init_peak_bytes": [rk["init_peak_bytes"] for rk in ranks],
           "rank_peak_bytes": [rk["peak_bytes"] for rk in ranks],
           "rank_launches": [{n: rk["launches"][n] for n in LM_KERNELS} for rk in ranks],
           "launches": {n: sum(rk["launches"][n] for rk in ranks) for n in LM_KERNELS},
           "moe_mode": cfg.moe_mode(TP) if cfg.n_experts else None,
           "dropped_share": [rk["routed"][0] / rk["routed"][1] if rk["routed"][1] else None
                             for rk in ranks]}
    log(f"{phase} {cfg.name}: {json.dumps(res)}")
    bad = []
    if not loss_rel <= TP_LOSS_RTOL:
        bad.append(f"loss {loss_rel:.3e} relative > {TP_LOSS_RTOL}")
    if over:
        bad.append(f"{len(over)} gradients past {bound:.3e} of their max: {over[:5]}")
    for r, rk in enumerate(ranks):
        got = {k: rk["bytes"][k] for k in expect}
        if got != expect or sum(rk["bytes"].values()) != sum(expect.values()):
            bad.append(f"rank {r}'s collective bytes {rk['bytes']} against {expect}")
    if on_card:
        n_attn = sum(cfg.mixer_kind(i) == "attn" for i in range(cfg.n_layers))
        want = {"flash_attention": n_attn, "ssd": cfg.n_layers - n_attn}
        for r, rl in enumerate(res["rank_launches"]):
            for n, w in want.items():
                if rl[n] != w * (2 if cfg.remat else 1):
                    bad.append(f"rank {r} launched {n} {rl[n]} times, not "
                               f"{w * (2 if cfg.remat else 1)}")
    if bad:
        raise PhaseError(f"{phase} {cfg.name} failed: " + "; ".join(bad))
    return res


def shard(device, *, seed: int = 0, launch_loss: float | None = None, cfg=None,
          steps: int = 2, batch: int = 4, seq: int = 2048, ckpt_every: int = 1,
          smoke: bool = False, tp_seq: int = 512, tp_overrides: dict | None = None) -> dict:
    """Phase 17: (a) the launcher on SHARD_WORLD ranks sharing the card,
    killed after a checkpoint and relaunched; (b) one fp32 step on a
    (data, model) = TP_MESH mesh of qwen3-32b (TP_DENSE_LAYERS layers) and
    mamba2-370m (all its layers) against the unsharded step."""
    from repro_torch.configs import get_config

    if torch.device(device).type == "cuda":
        build_kernels()  # the ranks' processes load this build
    cfg = cfg or get_config(LAUNCH_ARCH)
    res = {"launcher": shard_launcher(device, cfg, steps=steps, batch=batch, seq=seq,
                                      ckpt_every=ckpt_every, smoke=smoke,
                                      one_rank_loss=launch_loss),
           "dense": tensor_parallel(device, TP_DENSE_ARCH, seq=tp_seq, seed=seed,
                                    overrides=tp_overrides),
           "mamba": tensor_parallel(device, LAUNCH_ARCH, seq=tp_seq, seed=seed,
                                    overrides=tp_overrides)}
    res["launches"] = {n: sum(res[k]["launches"][n] for k in ("launcher", "dense", "mamba"))
                       for n in LM_KERNELS}
    return res


# ---------------------------------------------------------------------------


def shard_launch(device, *, seed: int = 0) -> dict:
    """Phase 17 (a) alone on every card of the machine: one rank per card
    when it has more than one (the launcher's group is then NCCL, by
    ``launch.mesh.backend_for``), else SHARD_WORLD ranks sharing the card
    over gloo. Step 1's loss is held to a one-rank launcher run here."""
    from repro_torch.configs import get_config

    build_kernels()
    cards = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
    return shard_launcher(device, get_config(LAUNCH_ARCH),
                          world=cards if cards > 1 else SHARD_WORLD)


# ---------------------------------------------------------------------------
# 18. MoE across the model axis; 19. decode and ServeEngine under a mesh
# ---------------------------------------------------------------------------

#: phase 18's models at full width, cut in depth, each in its MoE layout:
#: Jamba's first two layers (Mamba + dense MLP, Mamba + MoE; ``ep``, its
#: own ``moe_mode(16)``), granite-moe's first (attention + MoE; ``tp``
#: forced: its 512-wide ff makes ``auto`` ``replicate`` at 16; 2 layers
#: cut to 1 for the script's time limit).
MOE_SHARD = {"jamba-v0.1-52b": ({"n_layers": 2}, "ep"),
             "granite-moe-3b-a800m": ({"n_layers": 1, "moe_sharding": "tp"}, "tp")}
#: phase 18's case for one rank a card only: llama4-scout at full width cut
#: to 1 layer (40 q heads padded to 48 over 8 kv heads; 16 experts of 3 x
#: 5 120 x 8 192 in ``ep``, 8 a rank, top_k 1, a shared expert; vocabulary
#: 202 048): ~4.3e9 parameters, 17 GB in fp32 and as much again in
#: gradients, which four ranks sharing one card over gloo would stage
#: through the host. Its top_k = 1 router takes no gradient (TP_ZERO_TOL).
MOE_PER_CARD = {"llama4-scout-17b-a16e": ({"n_layers": 1}, "ep")}


def moe_shard(device, *, seed: int = 0, seq: int = 512, overrides: dict | None = None,
              timeout: float = 900.0, cases: dict | None = None) -> dict:
    """Phase 18: one fp32 gradient (``loss_and_grads``, no optimizer state)
    of each case (``cases``, by default MOE_SHARD's models and, where the
    ranks run one a card, MOE_PER_CARD's) on a (data, model) = TP_MESH mesh
    of ranks, one row of ``seq`` tokens a data rank, against the same
    gradient unsharded on the card once the ranks have exited
    (``tensor_parallel``'s gates: loss, every gradient leaf over its max,
    each rank's bytes ``shard_step_bytes`` without the norm, K8 / K9 in
    every layer on every rank, twice under remat). ``overrides`` (the CPU
    rehearsal's widths) apply to every model."""
    from repro_torch.models.config import TP

    if torch.device(device).type == "cuda":
        build_kernels()  # the ranks' processes load this build
    world = TP_MESH[0] * TP_MESH[1]
    per_card = rank_route(0, world, device, cards_of(device))[1] == "nccl"
    if cases is None:
        cases = {**MOE_SHARD, **(MOE_PER_CARD if per_card else {})}
        if not per_card:
            log(f"moe_shard: {', '.join(MOE_PER_CARD)} runs with one rank a card only "
                f"({cards_of(device)} card(s) for {world} ranks)")
    res = {}
    for arch, (cut, mode) in cases.items():
        over = {**cut, **(overrides or {})}
        if tp_config(arch, **over).moe_mode(TP) != mode:
            raise PhaseError(f"moe_shard: {arch} is not in the {mode} layout")
        t0 = time.perf_counter()
        res[arch] = tensor_parallel(device, arch, seq=seq, seed=seed, overrides=over,
                                    adamw=False, phase="moe_shard", timeout=timeout)
        res[arch]["phase_s"] = time.perf_counter() - t0
    res["launches"] = {n: sum(res[a]["launches"][n] for a in cases) for n in LM_KERNELS}
    return res


#: phase 19: (a) Jamba at full width cut to SERVE_JAMBA_LAYERS layers, four
#: slots, the cache's sequence over ``model`` (decode_32k's layout); (b)
#: gemma-2b at full width cut to SERVE_GEMMA_LAYERS layers, one sequence,
#: its cache over all four ranks (long_500k's). Both in fp32, on (data 2,
#: model 2).
SERVE_MESH = (2, 2)
#: phase 19 (a)'s depth: Mamba + dense MLP, Mamba + MoE, twice, then
#: attention + dense MLP: every kind of layer of Jamba's 8-layer period.
#: The whole period's 4 MoE layers hold 90 GB of fp32 expert blocks on four
#: ranks; in bf16 two orders of the same decode part by more than 3e-2 of
#: max|logits| even with the MoE routing fixed, so no bf16 gate tells a
#: right decode from a wrong one.
SERVE_JAMBA_LAYERS = 5
#: phase 19 (b)'s depth: half of gemma-2b's 18 layers (every layer alike),
#: cut for the script's time limit (its 136 decode calls over gloo took
#: ~47 s of a slow host's 1 264 s at 18 layers)
SERVE_GEMMA_LAYERS = 9
SERVE_PARTS = {"a": dict(batch=4, prompt=32, max_len=2048, steps=8, join_at=2,
                        draw_in_turn=True),  # four ranks' draws at once exceed the card
               "b": dict(batch=1, prompt=128, max_len=32768, steps=8, draw_in_turn=False)}
#: phase 19's logits against the unsharded run's, over max|logits| (fp32)
SERVE_FP32_TOL = 1e-4


def serve_config(part: str, **overrides):
    """Phase 19's models, in fp32: (a) Jamba at full width cut to
    SERVE_JAMBA_LAYERS layers (4 Mamba, 1 attention, 2 MoE in ``ep``); (b)
    gemma-2b at full width cut to SERVE_GEMMA_LAYERS layers."""
    from repro_torch.configs import get_config

    if part == "a":
        return lm_config(**{"n_layers": SERVE_JAMBA_LAYERS, "dtype": "float32", **overrides})
    return dataclasses.replace(get_config(NYSTROM_ARCH), dtype="float32",
                               **{"n_layers": SERVE_GEMMA_LAYERS, **overrides})


def _engine_ops(prompt: int, steps: int, join_at: int, vocab: int, seed: int) -> list:
    """Phase 19 (a)'s script: requests (slot, prompt) on slots 0 and 1 at
    the start, slot 2's joining after ``join_at`` steps, ``steps`` steps
    (None) in all; the engine's other slots idle."""
    g = torch.Generator().manual_seed(seed + 2)
    prompts = torch.randint(0, vocab, (3, prompt), generator=g).tolist()
    ops: list = [(0, prompts[0]), (1, prompts[1])]
    for i in range(steps):
        if i == join_at:
            ops.append((2, prompts[2]))
        ops.append(None)
    return ops


def _serve_script(lm, part: str, inp: dict, device, rows: slice = slice(None)) -> tuple:
    """Phase 19's entry points on ``lm`` (its rows ``rows`` of the batch
    under a mesh): (a) ``ServeEngine`` through ``inp["ops"]``, (b)
    ``prefill`` of the prompt and ``inp["steps"]`` greedy steps. Returns
    (the outputs: the engine's tokens per slot, or the greedy tokens per
    step over the whole batch; the cache)."""
    from repro_torch.serving import ServeEngine, prefill, sample_greedy
    from repro_torch.sharding import collectives

    if part == "a":
        eng = ServeEngine(lm, max_len=inp["max_len"], batch_slots=inp["batch"],
                          device=str(device))
        for op in inp["ops"]:
            eng.step() if op is None else eng.add_request(*op)
        return [eng.finish(s) for s in range(inp["batch"])], eng.cache
    prompt = inp["prompt"]
    logits, cache = prefill(lm, inp["prompts"].to(device)[rows], inp["max_len"])
    outputs = []
    for i in range(inp["steps"]):
        tok = sample_greedy(logits, lm.cfg.vocab_size)
        outputs.append(collectives.gather_batch(tok).tolist())
        logits = lm.decode_step(cache, tok, prompt + i, length=prompt + i + 1)
    return outputs, cache


def serve_rank(rank: int, world: int, tmp: str, device: str, backend: str, part: str,
               overrides: dict, mesh: tuple[int, int], seed: int) -> None:
    """One rank of phase 19, in its own process (placed by ``rank_route``):
    ``serve_ctx``'s layout of the part's batch on a (data, model)
    ``DeviceMesh``, the seed's blocks drawn leaf by leaf (one rank at a
    time where the part says so: each whole leaf is drawn on the card
    before it is cut) and held by a weightless LM. Then ``prefill_logits``
    of the prompts (K8 / K9 counted) and ``_serve_script`` on the mesh, with
    the rank's own tokens and MoE routing, every ``decode_step`` call's
    inputs and logits kept on the card, the first under a
    ``CollectiveMeter``; then each call held to the unsharded run's call of
    the same index (the tokens and positions fed, the logits of the rank's
    block). Writes ``tmp/rank<r>.pt``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import kernels
    from repro_torch.launch.roofline import CollectiveMeter
    from repro_torch.models import LM, init_blocks, param_specs
    from repro_torch.models.model import padded_vocab
    from repro_torch.serving import prefill_logits
    from repro_torch.sharding import collectives, serve_ctx, set_mesh_ctx

    on_card = rank_setup(rank, world, tmp, device, backend)
    try:
        inp = torch.load(f"{tmp}/inputs.pt", weights_only=False)
        cfg = serve_config(part, **overrides)
        batch = inp["batch"]
        dmesh = init_device_mesh(torch.device(device).type, mesh,
                                 mesh_dim_names=("data", "model"))
        ctx = serve_ctx(dmesh, batch)
        set_mesh_ctx(ctx)
        plan = collectives.active()
        per = batch // plan.batch_ways
        rows = slice(plan.batch_index * per, (plan.batch_index + 1) * per)
        t0 = time.perf_counter()
        # at once on every rank: a process's first meta-device model imports
        # torch's meta kernels, seconds of host time
        specs = param_specs(cfg, ctx)
        blocks, draw_s = None, 0.0
        for r in range(world if inp["draw_in_turn"] else 1):
            if not inp["draw_in_turn"] or r == rank:
                t1 = time.perf_counter()
                blocks = init_blocks(cfg, specs, dmesh, seed=seed, device=device)
                _free(device)  # the whole leaves' memory, back to the card for the next rank
                draw_s = time.perf_counter() - t1
            dist.barrier()
        lm = LM(cfg, device="meta").load_blocks(blocks)
        del blocks
        vp = padded_vocab(cfg)

        def whole(t):  # the rank's rows and vocabulary block -> every row and column
            n = t.shape[0]
            t = collectives.model_blocks(t.float())[0].reshape(n, -1)[:, :vp]
            return collectives.gather_batch(t).cpu()

        res = {"init_s": time.perf_counter() - t0, "draw_s": draw_s}
        kernels.reset_launch_counts()
        got = whole(prefill_logits(lm, {"tokens": inp["prompts"].to(device)[rows]}))
        sync(device)
        res.update(launches=kernels.launch_counts(), plain=kernels.plain_counts(),
                   prefill_err=_leaf_err(got, inp["prefill_ref"]))
        seen, step_s, step = [], [], lm.decode_step

        def kept(cache, token, pos, *, length=None):  # each call's inputs and logits kept
            sync(device)
            t1 = time.perf_counter()
            if not seen:
                with CollectiveMeter() as meter:
                    out = step(cache, token, pos, length=length)
                res["bytes"] = dict(meter.bytes)
            else:
                out = step(cache, token, pos, length=length)
            sync(device)
            step_s.append(time.perf_counter() - t1)
            seen.append((token.clone(),  # the engine updates its own in place
                         torch.as_tensor(pos).reshape(-1).expand(token.shape[0]).clone(),
                         out.float().clone()))
            return out

        lm.decode_step = kept
        outputs, cache = _serve_script(lm, part, inp, device, rows)
        res["cache_bytes"] = sum(t.numel() * t.element_size() for c in cache
                                 for t in c.values())
        del cache
        # call i against the unsharded run's call i: the tokens and positions
        # fed, and the logits of the rank's rows and vocabulary block over
        # max|logits| of the whole call
        calls, refs, errs, fed = inp["calls"], inp["refs"], [], []
        for i, (token, pos, out) in enumerate(seen):
            if i >= len(calls):
                fed.append(False)
                errs.append(math.inf)
                continue
            fed.append(torch.equal(token.cpu(), calls[i][0][rows])
                       and torch.equal(pos.cpu(), calls[i][1][rows]))
            lo = collectives.model_axis().rank * out.shape[1]
            want = refs[i][rows, lo:lo + out.shape[1]]  # a padded block past Vp: cut
            errs.append(float((out.cpu()[:, :want.shape[1]] - want).abs().max())
                        / max(float(refs[i].abs().max()), 1e-30))
        res.update(errs=errs, fed=fed, step_s=step_s, outputs=outputs,
                   peak_bytes=torch.cuda.max_memory_allocated() if on_card else None)
        torch.save(res, f"{tmp}/rank{rank}.pt")
    finally:
        set_mesh_ctx(None)
        dist.destroy_process_group()


def serve_mesh(device, part: str, *, seed: int = 0, overrides: dict | None = None,
               mesh: tuple[int, int] = SERVE_MESH, timeout: float = 900.0, **shape) -> dict:
    """Phase 19 part ``part`` (SERVE_PARTS' shapes, ``shape`` overriding
    them): the unsharded model on the card first (``prefill_logits`` and
    ``_serve_script``, every ``decode_step`` call recorded with its tokens,
    positions and logits), freed; then ``serve_rank`` on the mesh's ranks
    (``run_ranks``: one a card over NCCL, drawing their blocks at once,
    where the machine has the cards; else sharing the card over gloo), each
    running the same script with its own tokens and MoE routing. Gates, fp32: ``prefill_logits`` and every ``decode_step``
    call's logits within SERVE_FP32_TOL of max|logits| of the unsharded
    call's, every call fed the unsharded call's tokens and positions, the
    unsharded run's outputs on every rank; each rank's cache bytes the dry
    run's (``launch.specs``' decode layout at this batch and length), its
    bytes for one step ``decode_step_bytes``; on the card K8 / K9 launched
    in every attention / Mamba layer of the forward on every rank, and no
    plain call on the card's tensors."""
    import tempfile

    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.launch.specs import cache_sds
    from repro_torch.models import LM
    from repro_torch.serving import prefill_logits
    from repro_torch.sharding import MeshCtx, MeshShape

    sh = {**SERVE_PARTS[part], **shape}
    batch, prompt, max_len, steps = sh["batch"], sh["prompt"], sh["max_len"], sh["steps"]
    overrides = overrides or {}
    cfg = serve_config(part, **overrides)
    layout = "seq_shard_wide" if batch == 1 else "seq_model"
    on_card = torch.device(device).type == "cuda"
    world = mesh[0] * mesh[1]
    tol = SERVE_FP32_TOL
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                            generator=torch.Generator().manual_seed(seed + 3))
    # ranks sharing the card draw their blocks one at a time where the part
    # says so; one a card, all at once
    cards = cards_of(device)
    per_card = rank_route(0, world, device, cards)[1] == "nccl"
    inp = {"batch": batch, "max_len": max_len, "prompt": prompt, "steps": steps,
           "prompts": prompts, "draw_in_turn": sh["draw_in_turn"] and not per_card,
           "ops": _engine_ops(prompt, steps, sh["join_at"], cfg.vocab_size, seed)
           if part == "a" else None}
    # the unsharded run, every decode call recorded
    lm = LM(cfg, seed=seed, device=str(device))
    inp["prefill_ref"] = prefill_logits(lm, {"tokens": prompts.to(device)}).float().cpu()
    calls, refs, step = [], [], lm.decode_step

    def recorded(cache, token, pos, *, length=None):
        out = step(cache, token, pos, length=length)
        calls.append((token.cpu().clone(),  # the engine updates its own in place
                      torch.as_tensor(pos).reshape(-1).expand(token.shape[0]).cpu().clone()))
        refs.append(out.float().cpu())
        return out

    lm.decode_step = recorded
    sync(device)
    t0 = time.perf_counter()
    outputs, cache = _serve_script(lm, part, inp, device)
    del cache
    sync(device)
    unsharded_s = time.perf_counter() - t0
    del lm.decode_step, lm, step  # the recorder holds the model: drop it with the model
    _free(device)
    inp.update(calls=calls, refs=refs)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        torch.save(inp, f"{tmp}/inputs.pt")
        ranks, run = run_ranks("serve_rank", world, tmp, device,
                               (part, overrides, tuple(mesh), seed),
                               phase=f"serve_shard ({part}) {cfg.name}", timeout=timeout,
                               cards=cards)
    dry = tree_bytes(cache_sds(cfg, batch, max_len,
                               MeshCtx(mesh=MeshShape(("data", "model"), tuple(mesh)))))
    expect = decode_step_bytes(cfg, mesh[0], mesh[1], batch, max_len, layout)

    def median(v):
        return sorted(v)[len(v) // 2]

    res = {"part": part, "arch": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "mesh": list(mesh), "layout": layout, "batch": batch, "prompt": prompt,
           "max_len": max_len, "steps": steps, "calls": len(calls), "tol": tol,
           "prefill_err": [rk["prefill_err"] for rk in ranks],
           "step_err_worst": max(max(rk["errs"]) for rk in ranks),
           "step_err_median": max(median(rk["errs"]) for rk in ranks),
           "fed_alike": [len(rk["fed"]) == len(calls) and all(rk["fed"]) for rk in ranks],
           "outputs_same": [rk["outputs"] == outputs for rk in ranks], "outputs": outputs,
           "rank_cache_bytes": [rk["cache_bytes"] for rk in ranks], "dryrun_cache_bytes": dry,
           "bytes": [rk["bytes"] for rk in ranks], "expected_bytes": expect,
           "step_ms_median": [1e3 * median(rk["step_s"]) for rk in ranks],
           "unsharded_s": unsharded_s, **run, "draw_in_turn": inp["draw_in_turn"],
           "init_s": [rk["init_s"] for rk in ranks],
           "draw_s": [rk["draw_s"] for rk in ranks],
           "rank_peak_bytes": [rk["peak_bytes"] for rk in ranks],
           "rank_launches": [{n: rk["launches"][n] for n in LM_KERNELS} for rk in ranks],
           "plain": [rk["plain"] for rk in ranks],
           "launches": {n: sum(rk["launches"][n] for rk in ranks) for n in LM_KERNELS}}
    log(f"serve_shard ({part}) {cfg.name}: {json.dumps(res)}")
    bad = []
    for r, rk in enumerate(ranks):
        if not rk["prefill_err"] <= tol:
            bad.append(f"rank {r}'s prefill_logits {rk['prefill_err']:.3e} of max > {tol}")
        over = [i for i, e in enumerate(rk["errs"]) if not e <= tol]
        if over:
            bad.append(f"rank {r}: {len(over)} decode calls past {tol} of max|logits|, the "
                       f"first {over[0]}, the worst {max(rk['errs']):.3e}")
        if not res["fed_alike"][r]:
            first = next((i for i, ok in enumerate(rk["fed"]) if not ok), len(rk["fed"]))
            bad.append(f"rank {r} made {len(rk['fed'])} decode calls against the unsharded "
                       f"run's {len(calls)}, the first fed other tokens or positions: {first}")
        if not res["outputs_same"][r]:
            bad.append(f"rank {r}'s outputs differ from the unsharded run's")
        if rk["cache_bytes"] != dry:
            bad.append(f"rank {r}'s cache {rk['cache_bytes']} B, the dry run's {dry}")
        got = {k: rk["bytes"][k] for k in expect}
        if got != expect or sum(rk["bytes"].values()) != sum(expect.values()):
            bad.append(f"rank {r}'s collective bytes {rk['bytes']} against {expect}")
    if on_card:
        n_attn = sum(cfg.mixer_kind(i) == "attn" for i in range(cfg.n_layers))
        want = {"flash_attention": n_attn, "ssd": cfg.n_layers - n_attn}
        for r, (rl, pl) in enumerate(zip(res["rank_launches"], res["plain"])):
            if rl != want:
                bad.append(f"rank {r} launched {rl} in prefill_logits, not {want}")
            if any(v["cuda_calls"] for v in pl.values()):
                bad.append(f"rank {r} called a plain version on the card: {pl}")
    if bad:
        raise PhaseError(f"serve_shard ({part}) {cfg.name} failed: " + "; ".join(bad))
    return res


def serve_shard(device, *, seed: int = 0, overrides: dict | None = None,
                timeout: float = 900.0, **shapes) -> dict:
    """Phase 19: ``serve_mesh`` (a) and (b); ``overrides`` and ``shapes``
    ({"a": {...}, "b": {...}}) are the CPU rehearsal's."""
    if torch.device(device).type == "cuda":
        build_kernels()  # the ranks' processes load this build
    res = {}
    for part in SERVE_PARTS:
        t0 = time.perf_counter()
        res[part] = serve_mesh(device, part, seed=seed, overrides=(overrides or {}).get(part),
                               timeout=timeout, **shapes.get(part, {}))
        res[part]["phase_s"] = time.perf_counter() - t0
    res["launches"] = {n: sum(res[p]["launches"][n] for p in SERVE_PARTS) for n in LM_KERNELS}
    return res


# ---------------------------------------------------------------------------
# 20. the reference's padded heads; BLESS cache compression under a mesh
# ---------------------------------------------------------------------------

#: phase 20's models in fp32, the reference's padding regrouping their GQA
#: heads: (a) granite-moe-3b-a800m at full width and depth, 24 q heads padded
#: to 32 over 8 kv heads (group 4 where the published grouping is 3),
#: unsharded; (b) qwen2-vl-2b at full width cut to 4 layers, 12 q heads
#: padded to 16 over 2 kv heads (group 8, not 6), on PADDED_MESH, where
#: ``model`` rank 3 holds only the padded heads 12-15.
PADDED_ARCHS = {"a": ("granite-moe-3b-a800m", {}), "b": ("qwen2-vl-2b", {"n_layers": 4})}
PADDED_MESH = (1, 4)
#: (a): ``prefill_logits`` of batch x prompt tokens; ``ServeEngine`` with one
#: slot a row, each fed the first serve_prompt tokens of its row, then steps
#: greedy steps. (b): ``prefill_logits`` of batch x prompt tokens (the first
#: 1 024 the image's patch embeddings), steps decode calls on a cache of
#: max_len rows, then each attention layer's cache compressed to m rows.
PADDED_SHAPES = {"a": dict(batch=2, prompt=512, serve_prompt=16, steps=16),
                 "b": dict(batch=2, prompt=1280, max_len=1024, steps=8, m=256)}
#: phase 20's logits against the referee's and the unsharded run's, over max|logits| (fp32)
PADDED_TOL = 1e-4


def padded_config(part: str, **overrides):
    """Phase 20 part ``part``'s model (PADDED_ARCHS), fp32."""
    from repro_torch.configs import get_config

    arch, cut = PADDED_ARCHS[part]
    return dataclasses.replace(get_config(arch), **{"dtype": "float32", **cut, **overrides})


def mha_referee(lm):
    """An MHA copy of ``lm`` (the same weights, held, not copied) with one kv
    head per padded q head: its ``wk`` / ``wv`` columns of padded q head h
    are ``lm``'s of kv head ``h // (padded q heads // n_kv_heads)``, the
    reference's head map written out here. Its attention runs at group 1."""
    from repro_torch.models import LM
    from repro_torch.models.config import TP

    cfg = lm.cfg
    hp, kvp, hd = cfg.padded_heads(TP), cfg.padded_kv_heads(TP), cfg.head_dim
    heads = torch.tensor([h // (hp // kvp) for h in range(hp)])
    blocks = {}
    for name, t in lm.named_parameters():
        if name.endswith((".attn.wk", ".attn.wv")):
            t = t.detach().reshape(t.shape[0], kvp, hd)[:, heads.to(t.device)].reshape(
                t.shape[0], hp * hd)
        blocks[name] = t.detach()
    return LM(dataclasses.replace(cfg, n_kv_heads=cfg.n_heads), device="meta").load_blocks(blocks)


def _recording(lm, calls: list):
    """``lm.decode_step`` recording each call's fp32 logits into ``calls``."""
    step = lm.decode_step

    def rec(cache, token, pos, *, length=None):
        out = step(cache, token, pos, length=length)
        calls.append(out.float().clone())
        return out

    lm.decode_step = rec


def padded_unsharded(device, *, seed: int = 0, overrides: dict | None = None,
                     **shape) -> dict:
    """Phase 20 (a): ``prefill_logits`` and ``ServeEngine`` of the padded
    model (K8 at the reference's group) against ``mha_referee`` of the same
    weights (K8 at group 1). Gates: the prefill logits and every decode
    call's within PADDED_TOL of max|logits|, the same greedy tokens, finite
    logits; on the card K8 launched in every layer of the prefill and no
    plain call on the card."""
    from repro_torch import kernels
    from repro_torch.models import LM
    from repro_torch.models.config import TP
    from repro_torch.serving import ServeEngine, prefill_logits

    sh = {**PADDED_SHAPES["a"], **shape}
    cfg = padded_config("a", **(overrides or {}))
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM(cfg, seed=seed, device=str(device))
    ref = mha_referee(lm)
    sync(device)
    init_s = time.perf_counter() - t0
    g = torch.Generator().manual_seed(seed + 4)
    tokens = torch.randint(0, cfg.vocab_size, (sh["batch"], sh["prompt"]), generator=g)
    bat = {"tokens": tokens.to(device)}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = prefill_logits(lm, bat).float()
    sync(device)
    prefill_s = time.perf_counter() - t0
    launches, plain = kernels.launch_counts(), kernels.plain_counts()
    want = prefill_logits(ref, bat).float()
    runs = {}
    for name, model in (("padded", lm), ("referee", ref)):
        calls: list = []
        _recording(model, calls)
        eng = ServeEngine(model, max_len=sh["serve_prompt"] + sh["steps"] + 1,
                          batch_slots=sh["batch"], device=str(device))
        sync(device)
        t0 = time.perf_counter()
        for slot in range(sh["batch"]):
            eng.add_request(slot, tokens[slot, :sh["serve_prompt"]].tolist())
        for _ in range(sh["steps"]):
            eng.step()
        sync(device)
        runs[name] = {"outputs": [eng.finish(s) for s in range(sh["batch"])], "calls": calls,
                      "s": time.perf_counter() - t0}
        del model.decode_step, eng
    errs = [_leaf_err(a, b) for a, b in zip(runs["padded"]["calls"], runs["referee"]["calls"])]
    finite = bool(torch.isfinite(got).all()) and all(bool(torch.isfinite(c).all())
                                                    for c in runs["padded"]["calls"])
    res = {"part": "a", "arch": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.padded_heads(TP)],
           "group": cfg.padded_heads(TP) // cfg.padded_kv_heads(TP), **sh,
           "prefill_err": _leaf_err(got, want), "calls": len(errs),
           "step_err_worst": max(errs, default=math.inf),
           "step_err_median": sorted(errs)[len(errs) // 2] if errs else math.inf,
           "outputs_same": runs["padded"]["outputs"] == runs["referee"]["outputs"],
           "outputs": runs["padded"]["outputs"], "finite": finite, "init_s": init_s,
           "prefill_s": prefill_s, "engine_s": runs["padded"]["s"],
           "referee_engine_s": runs["referee"]["s"],
           "peak_bytes": torch.cuda.max_memory_allocated() if on_card else None,
           "launches": launches, "plain": plain}
    del lm, ref, runs
    _free(device)
    log(f"padded_heads (a) {cfg.name}: {json.dumps(res)}")
    bad = []
    if not res["prefill_err"] <= PADDED_TOL:
        bad.append(f"prefill_logits {res['prefill_err']:.3e} of max > {PADDED_TOL}")
    if len(errs) != sh["batch"] * sh["serve_prompt"] + sh["steps"]:
        bad.append(f"{len(errs)} decode calls on one side")
    if not res["step_err_worst"] <= PADDED_TOL:
        bad.append(f"decode calls up to {res['step_err_worst']:.3e} of max > {PADDED_TOL}")
    if not res["outputs_same"]:
        bad.append("the engine's tokens differ from the referee's")
    if not finite:
        bad.append("non-finite logits")
    if on_card:
        if launches["flash_attention"] != cfg.n_layers:
            bad.append(f"K8 launched {launches['flash_attention']} times in the prefill, not "
                       f"{cfg.n_layers}")
        if any(v["cuda_calls"] for v in plain.values()):
            bad.append(f"a plain version ran on the card: {plain}")
    if bad:
        raise PhaseError(f"padded_heads (a) {cfg.name} failed: " + "; ".join(bad))
    return res


def _padded_batch(cfg, inp: dict, rows: slice, device) -> dict:
    """Phase 20 (b)'s prompt batch (rows ``rows``): tokens, the image's patch
    embeddings over the first ``extra_image_tokens`` positions, M-RoPE
    positions (three equal streams)."""
    tokens = inp["tokens"][rows]
    b, s = tokens.shape
    pos = torch.arange(s).expand(b, 3, s)
    return {"tokens": tokens.to(device), "pixel_embeds": inp["pixel_embeds"][rows].to(device),
            "mrope_positions": pos.to(device)}


def _padded_decode(lm, cache: list, inp: dict, rows: slice, device, first=None) -> list:
    """Phase 20 (b)'s decode calls (rows ``rows``): call i feeds
    ``inp["steps"][:, i]`` at position i, length i + 1, M-RoPE position i
    on every stream; ``first`` wraps the first call (a meter). Returns the
    fp32 logits of each call."""
    out = []
    for i in range(inp["steps"].shape[1]):
        tok = inp["steps"][rows, i].to(device)
        mpos = torch.full((tok.shape[0], 3, 1), i, device=device)
        with first() if first is not None and i == 0 else contextlib.nullcontext():
            out.append(lm.decode_step(cache, tok, i, length=i + 1, mrope_pos=mpos).float())
    return out


def padded_rank(rank: int, world: int, tmp: str, device: str, backend: str,
                overrides: dict, mesh: tuple[int, int], seed: int) -> None:
    """One rank of phase 20 (b), in its own process (``device`` the rank's
    card, ``backend`` its group's): ``serve_ctx``'s layout on a (data, model)
    ``DeviceMesh``, the seed's blocks drawn leaf by leaf, held by a
    weightless LM. ``prefill_logits`` (K8 counted), the decode calls on
    ``init_cache``'s blocks filled with the rank's block of the run's fill
    (the first under a ``CollectiveMeter``), each call held to the
    unsharded run's (the rank's rows and vocabulary block of its logits);
    then ``bless_compress_cache`` of every attention layer's blocks, kept
    with the blocks it compressed. Writes ``tmp/rank<r>.pt``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import kernels
    from repro_torch.launch.roofline import CollectiveMeter
    from repro_torch.models import LM, init_blocks, param_specs
    from repro_torch.models.attention import bless_compress_cache
    from repro_torch.serving import prefill_logits
    from repro_torch.sharding import collectives, serve_ctx, set_mesh_ctx

    on_card = rank_setup(rank, world, tmp, device, backend)
    try:
        inp = torch.load(f"{tmp}/inputs.pt", weights_only=False)
        cfg = padded_config("b", **overrides)
        batch = inp["tokens"].shape[0]
        dmesh = init_device_mesh(torch.device(device).type, mesh,
                                 mesh_dim_names=("data", "model"))
        ctx = serve_ctx(dmesh, batch)
        set_mesh_ctx(ctx)
        plan = collectives.active()
        per = batch // plan.batch_ways
        rows = slice(plan.batch_index * per, (plan.batch_index + 1) * per)
        t0 = time.perf_counter()
        lm = LM(cfg, device="meta").load_blocks(
            init_blocks(cfg, param_specs(cfg, ctx), dmesh, seed=seed, device=device))
        res = {"init_s": time.perf_counter() - t0}
        lo = collectives.model_axis().rank

        def err(out, ref):  # the rank's rows and vocabulary block against the whole call's
            w = out.shape[1]
            want = ref[rows, lo * w:(lo + 1) * w]
            return (float((out.cpu()[:, :want.shape[1]] - want).abs().max())
                    / max(float(ref.abs().max()), 1e-30))

        kernels.reset_launch_counts()
        got = prefill_logits(lm, _padded_batch(cfg, inp, rows, device)).float()
        sync(device)
        res.update(launches=kernels.launch_counts(), plain=kernels.plain_counts(),
                   prefill_err=err(got, inp["prefill_ref"]))
        cache = lm.init_cache(batch, inp["max_len"])
        n = cache[0]["k"].shape[1]
        at = slice(plan.kv_index * n, (plan.kv_index + 1) * n)
        for c, (k, v) in zip(cache, inp["fill"]):
            c["k"].copy_(k[rows, at])
            c["v"].copy_(v[rows, at])
        meter = CollectiveMeter()
        sync(device)
        t0 = time.perf_counter()
        outs = _padded_decode(lm, cache, inp, rows, device, first=lambda: meter)
        sync(device)
        res.update(step_s=(time.perf_counter() - t0) / len(outs), bytes=dict(meter.bytes),
                   errs=[err(o, r) for o, r in zip(outs, inp["refs"])],
                   cache_bytes=sum(t.numel() * t.element_size() for c in cache
                                   for t in c.values()))
        t0 = time.perf_counter()
        packed = [bless_compress_cache(c["k"], c["v"], inp["m"]) for c in cache]
        sync(device)
        res["compress_s"] = time.perf_counter() - t0
        res.update(kv_index=plan.kv_index, rows=(rows.start, rows.stop),
                   cache=[(c["k"].cpu(), c["v"].cpu()) for c in cache],
                   packed=[(kc.cpu(), vc.cpu()) for kc, vc in packed],
                   peak_bytes=torch.cuda.max_memory_allocated() if on_card else None)
        torch.save(res, f"{tmp}/rank{rank}.pt")
    finally:
        set_mesh_ctx(None)
        dist.destroy_process_group()


def padded_mesh(device, *, seed: int = 0, overrides: dict | None = None,
                mesh: tuple[int, int] = PADDED_MESH, cards: int = 1, timeout: float = 600.0,
                **shape) -> dict:
    """Phase 20 (b): the unsharded model on the card first (``prefill_logits``
    and the decode calls on a cache whose rows are first filled from the
    seed), every result kept, the model freed; then ``padded_rank`` on the
    mesh's ranks, sharing the card over gloo, or one a card over NCCL when
    ``cards`` holds the mesh. The fill stands for earlier traffic: each
    call's length masks the rows past its position, so the logits see only
    the rows the calls wrote, and the compression sees a whole cache.
    Gates: ``prefill_logits`` and every decode call within PADDED_TOL of
    max|logits| of the unsharded call's; every rank's compressed blocks bit
    for bit the unsharded ``bless_compress_cache`` on the card of the cache
    the ranks hold, assembled from their blocks (the rows the calls wrote
    carry the ranks' rounding, not the unsharded run's); each
    rank's cache bytes the dry run's and its bytes for one step
    ``decode_step_bytes``; on the card K8 in every layer of the prefill on
    every rank and no plain call on the card."""
    import tempfile

    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.launch.specs import cache_sds
    from repro_torch.models import LM
    from repro_torch.models.attention import bless_compress_cache
    from repro_torch.serving import prefill_logits
    from repro_torch.sharding import MeshCtx, MeshShape

    sh = {**PADDED_SHAPES["b"], **shape}
    overrides = overrides or {}
    cfg = padded_config("b", **overrides)
    on_card = torch.device(device).type == "cuda"
    world = mesh[0] * mesh[1]
    g = torch.Generator().manual_seed(seed + 5)
    batch, prompt, max_len = sh["batch"], sh["prompt"], sh["max_len"]
    inp = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g),
           "pixel_embeds": torch.randn((batch, cfg.extra_image_tokens, cfg.d_model), generator=g),
           "steps": torch.randint(0, cfg.vocab_size, (batch, sh["steps"]), generator=g),
           "max_len": max_len, "m": sh["m"]}
    lm = LM(cfg, seed=seed, device=str(device))
    every = slice(None)
    inp["prefill_ref"] = prefill_logits(lm, _padded_batch(cfg, inp, every, device)).float().cpu()
    cache = lm.init_cache(batch, max_len)
    inp["fill"] = [(torch.randn(c["k"].shape, generator=g), torch.randn(c["v"].shape, generator=g))
                   for c in cache]
    for c, (k, v) in zip(cache, inp["fill"]):
        c["k"].copy_(k)
        c["v"].copy_(v)
    sync(device)
    t0 = time.perf_counter()
    inp["refs"] = [o.cpu() for o in _padded_decode(lm, cache, inp, every, device)]
    sync(device)
    unsharded_step_s = (time.perf_counter() - t0) / sh["steps"]
    del lm, cache
    _free(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_padded_") as tmp:
        torch.save(inp, f"{tmp}/inputs.pt")
        ranks, run = run_ranks("padded_rank", world, tmp, device, (overrides, tuple(mesh), seed),
                               phase=f"padded_heads (b) {cfg.name}", timeout=timeout,
                               cards=cards)
    # the unsharded call on the ranks' cache, assembled from their blocks (the
    # rows the decode calls wrote are the ranks' own rounding of the unsharded
    # run's), against each rank's block of the compressed cache
    m, ways = sh["m"], mesh[1]  # seq_model: the sequence over model
    for rk in ranks:
        rk["compress_equal"] = []
    for layer in range(cfg.n_layers):
        by_rows: dict = {}
        for rk in ranks:
            by_rows.setdefault(rk["rows"], {})[rk["kv_index"]] = rk["cache"][layer]
        want = {}
        for rows, blocks in by_rows.items():
            k, v = (torch.cat([blocks[i][part] for i in range(ways)], dim=1).to(device)
                    for part in (0, 1))
            want[rows] = [t.cpu() for t in bless_compress_cache(k, v, m)]
        for rk in ranks:
            at = slice(rk["kv_index"] * (m // ways), (rk["kv_index"] + 1) * (m // ways))
            rk["compress_equal"].append(all(torch.equal(got, w[:, at]) for got, w in
                                            zip(rk["packed"][layer], want[rk["rows"]])))
    for rk in ranks:
        del rk["cache"], rk["packed"]
    dry = tree_bytes(cache_sds(cfg, batch, max_len,
                               MeshCtx(mesh=MeshShape(("data", "model"), tuple(mesh)))))
    expect = decode_step_bytes(cfg, mesh[0], mesh[1], batch, max_len, "seq_model")
    res = {"part": "b", "arch": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.padded_heads()],
           "group": cfg.padded_heads() // cfg.padded_kv_heads(), "mesh": list(mesh),
           **run, **sh, "tol": PADDED_TOL,
           "prefill_err": [rk["prefill_err"] for rk in ranks],
           "step_err_worst": max(max(rk["errs"]) for rk in ranks),
           "compress_equal": [all(rk["compress_equal"]) for rk in ranks],
           "rank_cache_bytes": [rk["cache_bytes"] for rk in ranks], "dryrun_cache_bytes": dry,
           "bytes": [rk["bytes"] for rk in ranks], "expected_bytes": expect,
           "step_ms": [1e3 * rk["step_s"] for rk in ranks],
           "unsharded_step_ms": 1e3 * unsharded_step_s,
           "compress_s": [rk["compress_s"] for rk in ranks],
           "init_s": [rk["init_s"] for rk in ranks],
           "rank_peak_bytes": [rk["peak_bytes"] for rk in ranks],
           "rank_launches": [{n: rk["launches"][n] for n in LM_KERNELS} for rk in ranks],
           "plain": [rk["plain"] for rk in ranks],
           "launches": {n: sum(rk["launches"][n] for rk in ranks) for n in LM_KERNELS}}
    log(f"padded_heads (b) {cfg.name}: {json.dumps(res)}")
    bad = []
    for r, rk in enumerate(ranks):
        if not rk["prefill_err"] <= PADDED_TOL:
            bad.append(f"rank {r}'s prefill_logits {rk['prefill_err']:.3e} of max > {PADDED_TOL}")
        if len(rk["errs"]) != sh["steps"] or not max(rk["errs"]) <= PADDED_TOL:
            bad.append(f"rank {r}'s decode calls {rk['errs']} of max (gate {PADDED_TOL})")
        if not all(rk["compress_equal"]):
            bad.append(f"rank {r}'s compressed cache differs from the unsharded call's in "
                       f"layers {[i for i, ok in enumerate(rk['compress_equal']) if not ok]}")
        if rk["cache_bytes"] != dry:
            bad.append(f"rank {r}'s cache {rk['cache_bytes']} B, the dry run's {dry}")
        got = {k: rk["bytes"][k] for k in expect}
        if got != expect or sum(rk["bytes"].values()) != sum(expect.values()):
            bad.append(f"rank {r}'s collective bytes {rk['bytes']} against {expect}")
    if on_card:
        for r, (rl, pl) in enumerate(zip(res["rank_launches"], res["plain"])):
            if rl["flash_attention"] != cfg.n_layers:
                bad.append(f"rank {r} launched {rl} in prefill_logits")
            if any(v["cuda_calls"] for v in pl.values()):
                bad.append(f"rank {r} called a plain version on the card: {pl}")
    if bad:
        raise PhaseError(f"padded_heads (b) {cfg.name} failed: " + "; ".join(bad))
    return res


def padded_heads(device, *, seed: int = 0, overrides: dict | None = None,
                 timeout: float = 600.0, **shapes) -> dict:
    """Phase 20: ``padded_unsharded`` (a) and ``padded_mesh`` (b), (b) one
    rank a card when the machine has the mesh's cards; ``overrides`` and
    ``shapes`` ({"a": {...}, "b": {...}}) are the CPU rehearsal's."""
    on_card = torch.device(device).type == "cuda"
    if on_card:
        build_kernels()  # the ranks' processes load this build
    over = overrides or {}
    res = {}
    t0 = time.perf_counter()
    res["a"] = padded_unsharded(device, seed=seed, overrides=over.get("a"), **shapes.get("a", {}))
    res["a"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["b"] = padded_mesh(device, seed=seed, overrides=over.get("b"), timeout=timeout,
                           cards=cards_of(device),
                           **shapes.get("b", {}))
    res["b"]["phase_s"] = time.perf_counter() - t0
    res["launches"] = {n: res["a"]["launches"][n] + res["b"]["launches"][n] for n in LM_KERNELS}
    return res


# ---------------------------------------------------------------------------
# 21. the examples: the five ``examples/*_torch.py`` scripts users run
# ---------------------------------------------------------------------------

#: each example's flags beside ``--seed`` and ``--device`` (its default sizes;
#: train_lm cut to 8 steps, each logged) and the kernels it must launch on
#: the card: K5 in BLESS, K1 / K2 / K3 in the fits, K4 in predict and
#: serving, K7 in the k-fold sweep, K8 / K9 in the LM's forward. The default
#: serve_batched (qwen3-32b's smoke config) has no Mamba layer, so it runs
#: again on Jamba's, which has both mixers.
EXAMPLES = {
    "quickstart": ([], ("rls_score", "gram", "falkon_matvec", "knm_t", "knm_matvec",
                        "falkon_matvec_masked")),
    "falkon_endtoend": ([], ("rls_score", "gram", "falkon_matvec", "knm_t", "knm_matvec")),
    "serve_krr": ([], ("rls_score", "gram", "falkon_matvec", "knm_t", "knm_matvec")),
    "serve_batched": ([], ("flash_attention",)),
    "serve_batched@jamba": (["--arch", "jamba-v0.1-52b"], ("flash_attention", "ssd")),
    "train_lm": (["--steps", "8", "--log-every", "1"], ("flash_attention",)),
}
#: falkon_endtoend's test error on the card against the same script on the
#: CPU at the same seed and size (two fp32 orders of one fit at lam 1e-6)
EXAMPLE_ERR_TOL = 1e-2


def example_module(name: str):
    """``examples/<name>_torch.py`` of this checkout, imported."""
    path = REPO / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _numbers(obj) -> list[float]:
    """Every number in a result tree of dicts, lists and tuples."""
    if isinstance(obj, dict):
        return [v for x in obj.values() for v in _numbers(x)]
    if isinstance(obj, (list, tuple)):
        return [v for x in obj for v in _numbers(x)]
    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        return [float(obj)]
    return []


def examples(device, *, seed: int = 0, flags: dict | None = None) -> dict:
    """Phase 21: each EXAMPLES script's ``main`` in this process on
    ``device`` at its default sizes (``flags``, the CPU rehearsal's, added
    per example), the launch counts reset before each and read after;
    beside them, in a process of its own on half the host's cores,
    falkon_endtoend with ``--device cpu`` at the same seed and size. Gates:
    every example returns numbers, all finite; on the card each launches
    the kernels EXAMPLES names, and every plain K8 / K9 call on the card is
    a training backward's recompute; falkon_endtoend's test error within
    EXAMPLE_ERR_TOL of the CPU run's."""
    import tempfile

    from repro_torch import kernels

    on_card = torch.device(device).type == "cuda"
    if on_card:
        build_kernels()
    flags = flags or {}
    res, bad = {}, []
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        def argv_of(key, dev):
            name = key.split("@")[0]
            ckpt = {"falkon_endtoend": ["--ckpt", f"{tmp}/{key}-{dev}"],
                    "train_lm": ["--ckpt-dir", f"{tmp}/{key}-{dev}"]}.get(name, [])
            return EXAMPLES[key][0] + flags.get(key, []) + ckpt + ["--seed", str(seed),
                                                                   "--device", dev]

        def run(key):
            name, argv = key.split("@")[0], argv_of(key, str(device))
            log(f"examples: {name}_torch.py {' '.join(argv)}")
            sync(device)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            out = example_module(name).main(argv)
            sync(device)
            return {"argv": argv, "seconds": time.perf_counter() - t0, "out": out,
                    "launches": {k: v for k, v in kernels.launch_counts().items() if v},
                    "plain": kernels.plain_counts()}

        # the CPU referee: the script as a user runs it with --device cpu; its
        # last line, main's result
        ref_argv = argv_of("falkon_endtoend", "cpu")
        code = ("import json, sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
                "out = chip_smoke.example_module('falkon_endtoend').main(sys.argv[2:]); "
                "print(json.dumps({k: v for k, v in out.items() if k != 'ckpt'}))")
        env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
               "OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 2) // 2))}
        t_ref = time.perf_counter()
        cpu = subprocess.Popen([sys.executable, "-c", code, str(REPO), *ref_argv], env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            for key in EXAMPLES:
                res[key] = run(key)
            text = cpu.communicate(timeout=900)[0]
        finally:
            if cpu.poll() is None:
                cpu.kill()
            cpu.wait()
        if cpu.returncode != 0:
            raise PhaseError(f"examples: falkon_endtoend with --device cpu exited "
                             f"{cpu.returncode}:\n{text[-3000:]}")
        ref = res["falkon_endtoend@cpu"] = {"argv": ref_argv, "out": json.loads(
            text.strip().splitlines()[-1]), "seconds": time.perf_counter() - t_ref,
            "launches": {}}
        for key, (_, want) in EXAMPLES.items():
            r = res[key]
            nums = _numbers(r["out"])
            if not nums or not all(math.isfinite(v) for v in nums):
                bad.append(f"{key} returned {r['out']!r}")
            if on_card:
                missing = [k for k in want if not r["launches"].get(k)]
                if missing:
                    bad.append(f"{key} launched no {missing} (launches {r['launches']})")
                extra = {k: v for k, v in r["plain"].items()
                         if v["cuda_calls"] != v["backward_recomputes"]}
                if extra:
                    bad.append(f"{key} called a plain version on the card outside a backward: "
                               f"{extra}")
    gap = abs(res["falkon_endtoend"]["out"]["test_err"] - ref["out"]["test_err"])
    if not gap <= EXAMPLE_ERR_TOL:
        bad.append(f"falkon_endtoend's test error {res['falkon_endtoend']['out']['test_err']} "
                   f"against {ref['out']['test_err']} with --device cpu: {gap:.4f} apart > "
                   f"{EXAMPLE_ERR_TOL}")
    out = {"seconds": {k: r["seconds"] for k, r in res.items()},
           "phase_s": time.perf_counter() - t_phase, "test_err_gap": gap,
           "launches": {n: sum(r["launches"].get(n, 0) for k, r in res.items() if k in EXAMPLES)
                        for n in {**KERNELS, **LM_KERNELS}},
           "examples": {k: {kk: v for kk, v in r.items() if kk != "out"} for k, r in res.items()}}
    log(f"examples: {json.dumps(out)}")
    if bad:
        raise PhaseError("examples failed: " + "; ".join(bad))
    out["results"] = {k: r["out"] for k, r in res.items()}
    return out


#: the phases ``--phase`` runs alone (each a function of this script).
ALONE = ("serve", "nystrom", "train", "launch", "shard", "shard_launch", "moe_shard",
         "serve_shard", "padded_heads", "examples")


def run_alone(names, tree: str | None, seed: int) -> int:
    """Only the phases ``names`` (no kernel record, no contract line), from
    this script or, with ``tree``, from the chip_smoke.py of that checkout
    with its own ``src`` (another commit unpacked by ``git archive``): each
    process runs one side of an A/B on the same card."""
    mod = sys.modules[__name__]
    if tree:
        path = pathlib.Path(tree).resolve() / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location("chip_smoke_tree", path)
        mod = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)  # puts that tree's src first on sys.path
    try:
        mod.probe()
        for name in names:
            t0 = time.perf_counter()
            res = getattr(mod, name)("cuda", seed=seed)
            keep = {k: v for k, v in res.items() if k in (
                "decode_ms_per_step", "prefill_tokens_per_s", "add_request_s",
                "nystrom_prefill_s", "exact_prefill_s")}
            keep.update({f"{k} ms_per_step": v["ms_per_step"] for k, v in res.items()
                         if isinstance(v, dict) and "ms_per_step" in v})
            log(f"alone {name} ({tree or 'this tree'}): {time.perf_counter() - t0:.1f} s "
                f"{json.dumps(keep)}")
    except mod.PhaseError as e:
        print(f"chip_smoke: FAIL {e}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the data and the centers")
    ap.add_argument("--phase", action="append", choices=ALONE,
                    help="run only this phase (repeatable); no kernel record or contract line")
    ap.add_argument("--tree", help="with --phase: the checkout whose chip_smoke.py and src run "
                    "the phases (to compare two commits on one card)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if args.tree and not args.phase:
        ap.error("--tree needs --phase")
    if args.phase:
        return run_alone(args.phase, args.tree, args.seed)
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    marks = [("start", t_start)]

    def mark(name: str) -> None:  # the seconds each phase took, logged at the end
        marks.append((name, time.perf_counter()))

    try:
        info = probe()
        build_kernels()
        mark("probe, build")
        parity_worst = kernel_parity("cuda", seed=args.seed)
        mark("parity")
        e2e = end_to_end("cuda", seed=args.seed)
        tensors = e2e.pop("tensors")
        mark("uniform")
        fb = bless_end_to_end("cuda", tensors, seed=args.seed)
        bless_t = fb.pop("tensors")
        mark("bless")
        calls = main_path_calls(tensors, sigma=4.0, bless_t=bless_t, seed=args.seed)
        errs = main_path_parity(calls)
        times = kernel_times(calls)
        del calls
        crossovers("cuda", times, seed=args.seed)
        mark("times")
        cv = cross_validation("cuda", tensors, bless_t["center_set"], seed=args.seed)
        mark("cv")
        clf = classify("cuda", tensors, bless_t["center_set"], fb["test_error"], seed=args.seed)
        mark("classifier")
        krr = krr_online("cuda", tensors, bless_t, seed=args.seed)
        mark("krr-online")
        rest = core_rest("cuda", tensors, bless_t, krr.pop("referee_t"), fb["test_error"])
        mark("core-rest")
        del tensors, bless_t  # the LM phases need the card's memory
        _free("cuda")
        lm_worst = lm_kernel_parity("cuda", seed=args.seed)
        wide = wide_kernel_times("cuda", seed=args.seed)
        mark("lm parity")
        dvf = decode_vs_forward("cuda", seed=args.seed)
        mark("decode")
        srv = serve("cuda", seed=args.seed)
        mark("serve")
        nys = nystrom("cuda", seed=args.seed)
        mark("nystrom")
        trn = train("cuda", seed=args.seed)
        mark("train")
        lch = launch("cuda", seed=args.seed)
        mark("launch")
        shd = shard("cuda", seed=args.seed, launch_loss=lch["launcher"]["losses"][0])
        mark("shard")
        moe = moe_shard("cuda", seed=args.seed)
        mark("moe_shard")
        srs = serve_shard("cuda", seed=args.seed)
        mark("serve_shard")
        pad = padded_heads("cuda", seed=args.seed)
        mark("padded_heads")
        exa = examples("cuda", seed=args.seed)
        mark("examples")
    except PhaseError as e:
        print(f"chip_smoke: FAIL {e}", file=sys.stderr)
        return 1
    # launches: the main paths' counts added (each reset just before its path):
    # the four FALKON paths, phase 12's serving / streaming / online work and
    # phase 13's sharded and guarded fits (its ranks' too) for K1-K7; for K8 and
    # K9 the LM forward of phase 10, the prefill + serving of phase 11, phase
    # 14's exact prefill, phase 15's training steps, phase 16's launcher
    # runs and pipeline ranks, phase 17's sharded ranks, phase 18's MoE ranks,
    # the prefill_logits of phase 19's serving ranks, and phase 20's padded
    # prefill and its ranks' prefill_logits, and the examples of phase 21
    paths = (e2e, fb, cv, clf, krr, rest, dvf, srv, nys, trn, lch, shd, moe, srs, pad, exa)
    launches = {name: sum(p["launches"].get(name, 0) for p in paths)
                for name in {**KERNELS, **LM_KERNELS}}
    for name in LM_KERNELS:
        errs[name] = srv["kernels"][name]["max_abs_err"]
        times[name] = srv["kernels"][name]
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": errs[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"], "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"], "library_ms": times[name]["library_ms"]}
        for name, (src, tpu) in {**KERNELS, **LM_KERNELS}.items()]}
    kernel_s = sum(e2e["launches"][n] * times[n]["ms"] for n in ("gram", "falkon_matvec",
                                                                  "knm_t")) / 1e3
    log(f"uniform fit: {e2e['fit_s']:.3f} s, of which kernels {kernel_s:.3f} s (launches x ms), "
        f"preconditioner {e2e['breakdown']['preconditioner_s']:.3f} s, sampler "
        f"{e2e['breakdown']['sample_s']:.3f} s; predict {e2e['predict_s']:.4f} s, with std "
        f"{e2e['predict_std_s']:.4f} s")
    log(f"FALKON-BLESS fit: {fb['fit_s']:.3f} s at M = {fb['m']}, sampler (repeat) "
        f"{fb['sample_s']:.3f} s, K2 {fb['launches']['falkon_matvec']} x "
        f"{fb['falkon_matvec_ms']:.3f} ms, preconditioner {fb['preconditioner_s']:.3f} s, "
        f"predict {fb['predict_s']:.4f} s; launches uniform path "
        f"{json.dumps(e2e['launches'])}, FALKON-BLESS path {json.dumps(fb['launches'])}")
    log(f"k-fold CV: sweep {cv['sweep_s']:.3f} s for {cv['folds']} folds x {len(cv['lams'])} "
        f"lams at M = {cv['m']} (K7 {cv['launches']['falkon_matvec_masked']} launches), best "
        f"lam {cv['best_lam']:g}; one naive refit {cv['naive_refit_s']:.3f} s, naive grid "
        f"estimate {cv['naive_grid_estimate_s']:.3f} s; mask tax {cv['mask_tax']['ratio']:.4f}; "
        f"classifier fit {clf['fit_s']:.3f} s, accuracy {clf['accuracy']:.5f} against "
        f"{clf['one_minus_bless_error']:.5f}; launches CV path {json.dumps(cv['launches'])}, "
        f"classifier path {json.dumps(clf['launches'])}")
    log(f"KRR serving: {krr['serve']['requests_per_s']:.1f} requests/s, "
        f"{krr['serve']['rows_per_s']:.1f} rows/s in {krr['serve']['dispatches']} waves "
        f"(buckets {krr['serve']['buckets']}, {krr['serve']['padded_rows']} padded rows, K4 "
        f"{krr['serve']['launches']['knm_matvec']} launches); async "
        f"{krr['async']['requests_per_s']:.1f} requests/s, p99 wave {krr['async']['p99_wave_s']} s; "
        f"streamed fit {krr['stream']['fit_s']:.3f} s (test error {krr['stream']['test_error']:.5f}, "
        f"peak {krr['stream']['peak_bytes_above_base']} B above base), durable fit {krr['durable']['fit_s']:.3f} s (resume "
        f"{krr['durable']['resume_s']:.3f} s, bit-identical {krr['durable']['bit_identical']}, "
        f"test error {krr['durable']['test_error']:.5f}); online refit median "
        f"{sorted(krr['online']['refit_ms'])[len(krr['online']['refit_ms']) // 2]:.2f} ms; launches "
        f"{json.dumps({k: v for k, v in krr['launches'].items() if v})}")
    # kernel time inside phase 12's wall times: launches x phase 6's CUDA-event
    # ms at the same shapes (the full wave and the full chunk: an upper bound,
    # as the last wave and chunk are smaller)
    k4_ms, k1_ms = times["knm_matvec@wave"]["ms"], times["gram@stream"]["ms"]
    log(f"krr-online kernel share: serving K4 {krr['serve']['launches']['knm_matvec']} x "
        f"{k4_ms:.4f} ms <= {krr['serve']['launches']['knm_matvec'] * k4_ms:.3f} ms of "
        f"{1e3 * krr['serve']['seconds']:.3f} ms wall; streamed fit K1 "
        f"{krr['stream']['launches']['gram']} x {k1_ms:.4f} ms <= "
        f"{krr['stream']['launches']['gram'] * k1_ms / 1e3:.4f} s of {krr['stream']['fit_s']:.4f} s; "
        f"fp64 referee distances {json.dumps(krr['referee'])}")
    ra, rb, rc, rd = rest["a"], rest["b"], rest["c"], rest["d"]
    log(f"core-rest: (a) one-rank sharded fit {ra['fit_s']:.3f} s ({ra['collectives']} "
        f"collectives) against the CudaBackend refit's {ra['reference_fit_s']:.3f} s and phase "
        f"5's FALKON-BLESS fit {fb['fit_s']:.3f} s; (b) {rb['world']} ranks ({rb['route']}): fits "
        f"{json.dumps(rb['fit_s'])} s, wall {rb['wall_s']:.1f} s, fp64 referee "
        f"{rb['referee']:.3e} (K2 fit {rb['k2_fit_referee']:.3e}), test error "
        f"{rb['test_error']:.5f}; (c) guarded {rc['fit_s']:.3f} s, dying primary raised "
        f"{rc['raised']}, events {rc['events']} naming fallbacks {rc['event_fallbacks']}; "
        f"(d) fused fit {rd['first']['fit_s']:.3f} s "
        f"(with the capture), repeat {rd['first']['repeat_fit_s']:.3f} s, replay alone "
        f"{rd.get('replay_ms', float('nan')):.2f} ms, host loop {rd['first']['host_fit_s']:.3f} s; "
        f"second bucket fit {rd['second']['fit_s']:.3f} s; fp64 referee fused / host "
        f"{rd['first']['fused_fp64']:.3e} / {rd['first']['host_fp64']:.3e} and "
        f"{rd['second']['fused_fp64']:.3e} / {rd['second']['host_fp64']:.3e}, second fit "
        f"against the host loop {rd['second']['pred_err']:.3e} of max|pred|; the first fit "
        f"left {rd['first']['allocated_bytes_after']} B allocated (its plan)")
    log(f"LM (Jamba, {dvf['n_layers']} layers at full width): decode vs forward "
        f"{dvf['delta_over_max']:.3e} of max|logit| in fp32; prefill "
        f"{srv['prefill_tokens_per_s']:.1f} tokens/s ({srv['batch']} x {srv['prompt']}, bf16), "
        f"decode {srv['decode_tokens_per_s']:.2f} tokens/s ({srv['decode_ms_per_step']:.2f} ms "
        f"per step, {srv['serve_slots']} slots); K8 {srv['kernels']['flash_attention']['ms']:.4f} "
        f"ms, K9 {srv['kernels']['ssd']['ms']:.4f} ms per call (at the wrapper's default chunk 128: "
        f"{srv['kernels']['ssd_chunk128']['ms']:.4f} ms, plain "
        f"{srv['kernels']['ssd_chunk128']['plain_ms']:.4f} ms)")
    g16, m16 = wide["flash_attention@gemma"], wide["ssd@mamba"]
    g32, g8 = wide["flash_attention@gemma@fp32"], wide["flash_attention@gemma-published"]
    log(f"K8 at gemma-2b's layer {json.dumps(list(GEMMA_ATTN))}, bf16: {g16['ms']:.4f} ms "
        f"(bound {g16['bound_ms']:.4f}, {g16['bound_by']}; SDPA {g16['library_ms']:.4f}; plain "
        f"{g16['plain_ms']:.3f}); fp32 {g32['ms']:.4f} ms (SDPA {g32['library_ms']:.4f}); at "
        f"its published heads {json.dumps(list(GEMMA_ATTN_PUBLISHED))}, bf16: {g8['ms']:.4f} "
        f"ms (bound {g8['bound_ms']:.4f}; SDPA {g8['library_ms']:.4f}; plain "
        f"{g8['plain_ms']:.3f}); K9 "
        f"at mamba2-370m's layer {json.dumps(list(MAMBA_SSD))}, bf16: {m16['ms']:.4f} ms "
        f"(bound {m16['bound_ms']:.4f}, {m16['bound_by']}; plain {m16['plain_ms']:.3f})")
    ly, cp = nys["layer"], nys["compress"]
    log(f"nystrom ({nys['arch']}, {nys['n_layers']} layers, {nys['dtype']}, {nys['prompt']} "
        f"tokens, {nys['landmarks']} landmarks): prefill {nys['nystrom_prefill_s']:.4f} s "
        f"against {nys['exact_prefill_s']:.4f} s exact (K8); one layer card vs CPU "
        f"{ly['err_over_max']:.3e} of max|out| (landmarks differing "
        f"{ly['landmarks']['differ']}), against exact attention {ly['vs_exact_rel_fro']:.3e} "
        f"(relative Frobenius), {ly['nystrom_ms']:.3f} ms vs K8 fp32 "
        f"{ly['exact_k8_fp32_ms']:.3f} ms; compress to {cp['m']} rows {cp['ms']:.3f} ms")
    for key in ("gemma", "mamba"):
        t = trn[key]
        resume = t.get("resume")
        log(f"train {t['arch']} ({t['n_layers']} layers, {t['dtype']}, {t['batch']} x "
            f"{t['seq']}, peak lr {t['peak_lr']}): {t['ms_per_step']:.1f} ms per step, "
            f"{t['tokens_per_s']:.1f} tokens/s, max allocated {t['max_memory_allocated']} B, "
            f"losses {json.dumps([round(x, 4) for x in t['losses']])}; held-out "
            f"{json.dumps(t['held_out']['before'])} -> {json.dumps(t['held_out']['after'])}, "
            f"trained batch {json.dumps(t['trained']['before'])} -> "
            f"{json.dumps(t['trained']['after'])}"
            + (f"; resume: save {resume['save_s']:.1f} s, restore {resume['restore_s']:.1f} s, "
               f"bit-identical {resume['bit_identical']}" if resume else ""))
    log("train parity (fp32, card against CPU; loss relative, worst gradient over its max): "
        + json.dumps([(p["arch"], p["loss_rel"], p["grad_worst"]) for p in trn["parity"]]))
    la, gp = lch["launcher"], lch["gpipe"]
    ra, rr = la["runs"]["uninterrupted"], la["runs"]["relaunched"]
    log(f"launch {la['arch']} ({la['n_layers']} layers, {la['batch']} x {la['seq']}, "
        f"{la['steps']} steps): {ra['done']['tokens_per_s']:.0f} tokens/s, median step "
        f"{ra['done']['median_step_s']:.3f} s, {ra['done']['stragglers']} stragglers; "
        f"saves {json.dumps(ra['checkpoints'])}; killed at step {la['runs']['killed']['latest_at_kill']}, "
        f"restore {rr['restore_s']:.3f} s, step-{la['steps']} checkpoints bit-identical "
        f"{la['bit_identical']} ({la['leaves']} leaves); peak {ra['peak_bytes']} B against the "
        f"dry run's per-rank state {la['dryrun_bytes_per_rank']['total']} B")
    log(f"gpipe ({gp['world']} ranks, {gp['route']}, {gp['n_layers']} layers, {gp['dtype']}, "
        f"{gp['microbatches']} x {json.dumps(gp['mb'])}): step {json.dumps(gp['step_s'])} s "
        f"against {gp['sequential_s']:.3f} s in sequence; output {gp['out_err']:.3e}, worst "
        f"gradient {gp['grad_worst']:.3e}; bytes per rank {json.dumps(gp['bytes'][0])}; wall "
        f"{gp['wall_s']:.1f} s")
    sa = shd["launcher"]
    log(f"shard (a) {sa['arch']} on {sa['world']} ranks (data {sa['world']}, {sa['route']}), "
        f"{sa['batch']} x {sa['seq']}: {sa['tokens_per_s']} tokens/s, median step "
        f"{sa['median_step_s']} s; step-{sa['steps']} checkpoints bit-identical "
        f"{sa['bit_identical']} ({sa['leaves']} leaves); step 1 loss {sa['losses'][0]} against "
        f"the one-rank {sa['one_rank_loss']}; state bytes a rank {json.dumps(sa['rank_state_bytes'])} "
        f"(dry run {sa['dryrun_bytes_per_rank']['params'] + sa['dryrun_bytes_per_rank']['opt']}); "
        f"peak {json.dumps(sa['rank_peak_bytes'])} B, during the init "
        f"{json.dumps(sa['rank_init_peak_bytes'])} B")
    for key in ("dense", "mamba"):
        sb = shd[key]
        log(f"shard (b) {sb['arch']} ({sb['n_layers']} layers, fp32, mesh {json.dumps(sb['mesh'])}, "
            f"{sb['route']}): "
            f"loss {sb['loss_rel']:.3e} relative, worst gradient {sb['grad_worst']:.3e} "
            f"({sb['grad_worst_param']}; bound {sb['grad_bound']:.3e}, the CPU referee's worst "
            f"{sb['referee_worst']}); step "
            f"{json.dumps([round(x, 3) for x in sb['step_s']])} s against {sb['unsharded_step_s']:.3f} s "
            f"unsharded; bytes a rank {json.dumps(sb['bytes'][0])}; peak "
            f"{json.dumps(sb['rank_peak_bytes'])} B; wall {sb['wall_s']:.1f} s")
    for arch in (a for a in moe if a != "launches"):
        m = moe[arch]
        log(f"moe_shard {m['arch']} ({m['n_layers']} layers, fp32, {m['moe_mode']}, mesh "
            f"{json.dumps(m['mesh'])}, {m['route']}): loss {m['loss_rel']:.3e} relative, worst "
            f"gradient "
            f"{m['grad_worst']:.3e} ({m['grad_worst_param']}; 0 in exact arithmetic "
            f"{json.dumps(m['zero_leaves'])}); gradient "
            f"{json.dumps([round(x, 3) for x in m['step_s']])} s against {m['unsharded_step_s']:.3f} s "
            f"unsharded; dropped {json.dumps(m['dropped_share'])}; bytes a rank "
            f"{json.dumps(m['bytes'][0])}; peak {json.dumps(m['rank_peak_bytes'])} B; phase "
            f"{m['phase_s']:.1f} s")
    for part in SERVE_PARTS:
        r = srs[part]
        log(f"serve_shard ({part}) {r['arch']} ({r['n_layers']} layers, {r['dtype']}, {r['layout']}, "
            f"batch {r['batch']}, cache {r['max_len']}, {r['route']}): prefill_logits "
            f"{max(r['prefill_err']):.3e}, decode calls median {r['step_err_median']:.3e}, worst "
            f"{r['step_err_worst']:.3e} of max|logits| (gate {r['tol']}) over {r['calls']} calls; "
            f"outputs the unsharded run's {r['outputs_same']}; decode "
            f"{json.dumps([round(x, 2) for x in r['step_ms_median']])} ms a step; cache "
            f"{r['rank_cache_bytes'][0]} B a rank; bytes a step {json.dumps(r['bytes'][0])}; peak "
            f"{json.dumps(r['rank_peak_bytes'])} B; phase {r['phase_s']:.1f} s")
    pa, pb = pad["a"], pad["b"]
    log(f"padded_heads (a) {pa['arch']} ({pa['n_layers']} layers, fp32, heads "
        f"{json.dumps(pa['heads'])}, group {pa['group']}) against its MHA referee: prefill_logits "
        f"{pa['prefill_err']:.3e}, decode calls median {pa['step_err_median']:.3e}, worst "
        f"{pa['step_err_worst']:.3e} of max|logits| over {pa['calls']} calls; tokens alike "
        f"{pa['outputs_same']}; prefill {pa['prefill_s']:.3f} s, engine {pa['engine_s']:.2f} s; "
        f"peak {pa['peak_bytes']} B; {pa['phase_s']:.1f} s")
    log(f"padded_heads (b) {pb['arch']} ({pb['n_layers']} layers, fp32, heads "
        f"{json.dumps(pb['heads'])}, group {pb['group']}, mesh {json.dumps(pb['mesh'])}, "
        f"{pb['route']}): prefill_logits {max(pb['prefill_err']):.3e}, decode calls worst "
        f"{pb['step_err_worst']:.3e} of max|logits|; compressed to {pb['m']} rows bit for bit "
        f"{pb['compress_equal']}; decode {json.dumps([round(x, 2) for x in pb['step_ms']])} ms a "
        f"call against {pb['unsharded_step_ms']:.2f} unsharded; peak "
        f"{json.dumps(pb['rank_peak_bytes'])} B; {pb['phase_s']:.1f} s")
    log(f"parity at ragged shapes, worst fp32 max_abs_err: "
        f"{json.dumps({**parity_worst, **lm_worst})}")
    ex = exa["results"]
    log(f"examples ({exa['phase_s']:.1f} s): seconds {json.dumps(exa['seconds'])}; falkon_endtoend "
        f"test error {ex['falkon_endtoend']['test_err']:.4f} on the card, "
        f"{ex['falkon_endtoend@cpu']['test_err']:.4f} with --device cpu; quickstart "
        f"FALKON-BLESS R^2 {ex['quickstart']['falkon_bless']['r2']:.3f}; serve_krr "
        f"{ex['serve_krr']['rows_per_s']:.0f} rows/s; train_lm losses "
        f"{json.dumps([round(v, 4) for _, v in ex['train_lm']])}")
    log("phase seconds: " + json.dumps({name: round(t - marks[i][1], 1)
                                        for i, (name, t) in enumerate(marks[1:])}))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(nvidia_smi())
    log(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                             "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
