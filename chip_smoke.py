#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (cloudtik_tpu_torch).

    python3 chip_smoke.py

Runs on one CUDA card and drives the port only (no JAX, nothing of
cloudtik_tpu).  Phases, each printed as one JSON line; any failure ends the
run with a non-zero exit:

  device   card name, count, `nvidia-smi` name and power limit
  build    builds every kernel from csrc/ (one nvcc per source, in parallel);
           registers and spills of each kernel from ptxas, and no spill
           in the main paths' bf16 D=128 flash kernels
  kernel   the forward kernel against its plain PyTorch version on the
           card, at the main path's shape and a few others, with the
           tolerance; kernel, plain and library (yardstick) times beside the
           bound
  kernel_bwd  the dq and dk/dv kernels against the plain backward, at the
           training path's shape and the same others, likewise; the
           forward's o and lse they read are held first
  serve    the inference path, part 2: `tik-serve`'s backend at tpu_1b
           width answering /v1/generate; greedy answers equal a direct
           `generate`
  engine   `tik-serve --engine`: the continuous-batching paged decode
           engine at tpu_1b width (8 slots, 1,024 tokens a request, blocks
           of 16, bf16) behind ServeServer, 16 concurrent HTTP clients
           (prompts of 32-700 tokens, half behind one shared 256-token
           prefix, one stopping at an EOS), every answer held by the
           tie-aware greedy check and every decode step's logits against
           a teacher-forced `forward_step`; prefix hits, prefill chunks,
           413, cancel, a free pool after; then an oversubscribed engine
           that must preempt, and two engines with a planted fault (block
           tables or lengths rolled one lane on) that the logits check
           must catch in every lane.  Tokens/s,
           TTFT/TPOT p50/p95 from the request ledger, mean decode-step ms
           with 8 lanes, peak memory; no B1-B5 launch on this path
  spec     `tik-serve --engine --spec-model`: `engine_backend(spec_model=,
           spec_k=4)` at tpu_1b behind ServeServer, 8 concurrent clients
           (prompts of 32-384 tokens, 32 new tokens; one sampled, which
           must not speculate; one stopping at an EOS its first round
           accepts), with a tpu_120m draft (random weights: rejection)
           and a tpu_1b self-draft (acceptance >= 0.8), beside a plain
           `--engine` run of the same requests; every greedy answer held
           by the tie-aware check and every verify row at an accepted or
           emitted position (and every plain decode step's row) by the
           logits check; a free pool after; a self-draft engine whose
           verify runs one position on must be flagged in every request.
           Tokens/s, TTFT/TPOT, ms per round and its split, acceptance,
           tokens per verify; no B1-B5 launch on this path
  lora     multi-tenant LoRA: `DecodeEngine(adapters=AdapterPool(...,
           capacity=3))` at tpu_1b, 4 rank-16 adapters on wq and wv:
           12 concurrent requests over the base model and the 4 adapters
           (gathered steps, an eviction, a wait on a pinned slot), a
           homogeneous run (merged steps), prefix isolation between
           adapters, an unknown adapter failing alone, a spec engine with
           one per-adapter tpu_120m draft; every answer and decode step
           against a teacher-forced forward over `merge_lora`, whose
           logits the adapters must move by >= 0.6; adapter indices
           rolled one lane on must be flagged in every changed lane; no
           B1-B5 launch on this path
  disagg   `tik-serve --engine --disagg`: `engine_backend(disagg=True,
           prefill_slots=2)` at the engine phase's configuration and
           traffic behind ServeServer: a prefill-role engine exports each
           finished prompt's KV blocks (gathered on the card, one copy to
           the host) over the in-process migration wire to the decode-role
           engine, which copies them back and scatters them into its pool.
           Every answer tie-aware and every decode-role step against the
           teacher; every record one migration of its whole prompt; prefix
           hits on both roles; one migrated request's blocks equal bit for
           bit in both pools; both pools free after stop; two requests
           torn by a planted `serve.kvcache.migrate` fault answer right
           through the fallback; a pair whose import lands its planes one
           block on must be flagged in every lane.  Tokens/s, TTFT/TPOT,
           and per migration the gather + d2h, pack + send and import ms,
           MB and GB/s, beside a monolithic `--engine` run of the same
           requests; no B1-B5 launch on this path
  fabric   the serving fabric: a PrefillReplica and two DecodeReplicas
           (tpu_1b engines over one set of weights) behind the copied
           prefix-affinity Router and a ReplicaRegistry, KV blocks over
           SocketKVTransport on 127.0.0.1: prompt-heavy requests migrate,
           short ones go direct, a torn migration falls back on the decode
           replica the router chose, and a prefill replica killed
           mid-traffic leaves every request answered (tie-aware, outcomes
           only).  The socket wire's GB/s and ms per handoff; no B1-B5
           launch on this path
  forward  the inference path, part 1: tpu_1b `forward` at B=4, S=2048 in
           bf16, held against the same forward on the reference attention
  train    the training path: `Trainer.fit` on tpu_1b at full width and
           depth, B=8, S=2048, bf16 params and moments, save_attn remat: 2
           warm-up steps, then 5 measured steps with 16 launches of each
           kernel per step; ms/step, tokens/s, MFU, peak memory
  checkpoint  the train path's configuration with checkpoints: 2 steps run
           twice from one state (with prefetch depth 0 and 2: whether the
           losses are bitwise equal, and data_wait per step), then 4 steps
           saving every 2 off the step loop into a temporary directory (it
           must have room for max_to_keep + 1 steps), step 4 torn by a
           planted `checkpoint.save` fault; a fresh Trainer resumes at
           step 2 past it, every leaf equal to the state saved, and runs
           steps 3-4 to the uninterrupted losses (bitwise when the probe
           was, else within twice its gap) with 16 launches of each flash
           kernel a step; `restore_latest_good` past the torn step
           removes it; `tik-serve`'s plain backend and engine serve the
           restored weights (tokens equal a direct `generate`; the engine
           by the tie-aware check).  Save stall, d2h and write seconds
           and GB/s, restore seconds, bytes per step, memory before and
           after a snapshot and peaks
  kernel_det  the NMS and ROIAlign kernels against their plain versions:
           NMS keep lists equal to the plain version's and to the JAX
           `nms_reference`'s (tests/torch_golden/, inputs rebuilt from
           each case's numpy seed) at the detect paths' shapes (SSD at 300
           and at 1200: 45,384 boxes an image), all-zero scores, fewer boxes
           than outputs, degenerate boxes, NaN scores and coordinates,
           signed zeros, +-inf and absent scores; ROIAlign
           within 1e-5 at Mask R-CNN's shapes, sampling 2 at scale 0.25,
           ROIs partly outside the map and under a pixel, 100 and 72
           channels, each on the route it must take (vector or
           strided); kernel and plain times beside the bound (no single
           PyTorch call computes either); then ROIAlign's gradient at Mask R-CNN's training shapes
           (B=4 x 128 ROIs, 7x7 and 14x14): the kernel forward held within
           1e-5 to the plain gather form's there, and the Function's
           gradient, with the kernel forward, is `roi_align_grad`'s, which
           is held within 1e-5 to the plain gather form's autograd
           gradient; its ms beside the kernel forward's
  kernel_paged  B6, the paged decode attention kernel, against its plain
           version on the same inputs at the serving cell's shape (32
           lanes, blocks of 16, 8 KV heads of 128, GQA group 4, 64 table
           slots) at two length mixes (lanes of 103-986 positions, and all
           1,024), in bf16 within one bf16 step; the append equal bit for
           bit; kernel time from a CUDA graph of 20 calls, the eager
           calls' time (the host's enqueue), the plain version's, and the
           bound (the lanes' K/V read once at 3.35 TB/s); no PyTorch call
           computes paged decode over a block table
  train_grads  tpu_1b width with 2 layers: the flash path's gradients
           against the reference attention path's, and the loss falling
           over 10 steps on one repeated batch
  lora_train  LoRA fine-tuning through `recipes.llama_lora_finetune.build`
           at its defaults (tpu_1b, f32 base, rank 16 on wq and
           wv, B=8, S=2048, AdamW): 2 warm-up and 6 measured steps on one
           repeated batch with 16 launches of each flash kernel a step,
           every base leaf unchanged, every adapter leaf moved, the loss
           falling; ms/step, tokens/s, MFU at 4/6 of the full flops, peak
           memory.  The adapter is saved by the port's Checkpointer and
           served by `engine_backend(adapters_dir=...)` beside the base:
           it must move the teacher's logits by >= 0.3, and every answer
           passes the tie-aware and logits checks against a teacher over
           `merge_lora`'d weights (the base's for base requests)
  bert     BERT-Large MLM pretraining through
           `recipes.bert_large_pretrain.build` (24 layers, d=1024,
           16 heads of 64, S=512, f32 params, bf16 compute) at B=32:
           2 warm-up and 5 measured steps on one repeated batch with 24
           launches of each flash kernel a step (non-causal, D=64) and the
           loss falling; ms/step, tokens/s, MFU, peak memory
  bert_grads  bert_large width with 2 layers: the flash path's gradients
           against the reference attention path's, as train_grads
  optim    sgd, adafactor, lion and adamw (bf16 moments), 5 updates each
           over a 2-layer tpu_1b layer stack on the card, held to the same
           optimizer on the CPU in f32
  detect   the detection path: `detect` of maskrcnn_resnet50 at B=8 x 512
           (2 ROIAlign launches and 1 NMS launch per call) and of
           ssd_resnet34 at B=8 x 300 and at B=8 x 1200 (1 NMS launch over
           3,000 or 45,384 anchors per call), bf16: ms per call, images/s,
           peak memory; outputs checked,
           each call's NMS and pooling held against the plain versions, and
           Mask R-CNN's map pooled on ROIAlign's vector route
  resnet_train, ssd_train, maskrcnn_train  the recipes' builders
           (`recipes.resnet50_imagenet`, `ssd_coco`, `maskrcnn_coco`) at the
           per-card batch of the JAX recipes' launch lines: resnet50 at
           B=128 x 224, ssd_resnet34 at B=32 x 300 (a positive anchor in
           every image), maskrcnn_resnet50 at B=4 x 512 with masks; 2 warm-up
           and 5 measured steps on one repeated batch, the loss falling;
           img/s, ms/step, MFU, peak memory, data_wait per step; no B1-B5
           launch but Mask R-CNN's exactly 2 ROIAlign launches a step on the
           vector route.  Mask R-CNN then takes one step's gradients with
           the kernel and with the plain ROIAlign forced: in f32 compute
           every leaf within 1e-3 relative L2; in the bf16 training
           configuration the median leaf within 0.05 and the largest
           within 0.25, beside a plain step whose pooled maps move by 1e-6
           (the bf16 noise floor); and it shows the ROI losses moving the
           backbone's gradient
  loaders  a writer thread publishes token shards (`export_token_shard`,
           `finish_export`) while `streaming_shard_batches` feeds
           `Trainer.fit(profile_dir=...)` on tpu_1b at full width and 2
           layers, B=8, S=2048, 3 steps: every batch equals the tokens
           published, the marker ends the stream, the Chrome trace names
           the three flash kernels, and `tokenized_file_batches` reads the
           same corpus as 3 batches
  diffusion_train, dlrm_train, rnnt_train, graphsage_train  the model
           zoo through its recipes' builders at full width: sdxl_mini at
           B=8 (64x64x4 latents, f32 params, bf16 compute; its attention
           head dims, 80 and 160, take no flash kernel), criteo_terabyte
           at B=8,192 (the whole 26 x 100,000 x 128 table stack on the
           card), rnnt at the JAX launch line's 8 utterances a card of 256
           frames and 64 labels, graphsage on 4,096-node blocks (then link
           prediction for 2 steps); 2 warm-up and 5 measured steps on one
           repeated batch, the loss falling; img/s, examples/s, frames/s or
           nodes/s, ms/step, MFU, peak memory; no B1-B5 launch.  Each is
           held to the CPU, f32 with TF32 off, one step's loss and every
           gradient leaf within 1e-3 relative L2 (diffusion_grads:
           sdxl_mini's widths at one block a stage and 16x16 latents, B=2;
           dlrm_grads: 2 tables, B=8,192; rnnt_grads: one encoder layer
           either side of the reduction, B=2 x 64 frames, where the card's
           transducer loss must also lie within 1e-4 of the float64 oracle
           and `greedy_decode` give the CPU's tokens; graphsage_grads: one
           4,096-node block)
  gbdt     the default GBDTConfig (100 trees, depth 6, 64 bins, logistic)
           fit on the card over 1,000,000 synthetic rows of 28 features:
           the training log-loss falling, ms per tree, predict rows/s; the
           forest saved with its edges and served by `tik-serve --gbdt`
           (its own process), whose /v1/predict for 1,000 rows must equal
           `predict_proba`; a forest without edges refused; then every
           round of a 20,000-row fit (logistic, and softmax at K=3) grown
           on the card and on the CPU from the CPU's scores: splits that
           partition the rows otherwise only at counted near ties, and the
           scores and probabilities of the rows no flip touched within
           1e-4; no B1-B5 launch

  moe_serve  the MoE inference path at tpu_moe_8x1b's full width and
           depth (16 layers, 8 experts, top-2, 4.73B parameters; f32
           parameters, bf16 compute): a prefill-shaped `forward` over 4
           prompts of 128 (16 B1 launches, logits held to the reference
           attention routed alike), `tik-serve` answering them (32
           greedy tokens each, equal to a direct `generate`; TTFT, TPOT,
           tokens/s), then
           `tik-serve --engine` with 8 concurrent clients, every answer
           tie-aware and every decode step's logits against a teacher that
           prefills and steps as `generate` does (MoE routes each call's
           rows), routed as the engine routed (in bf16 a third of the
           tokens route otherwise somewhere in 16 layers when two paths
           round differently), and a planted fault the logits check must
           flag in every lane; generation and the engine launch no B1-B5
           (einsums, as in the reference)
  moe_train  `Trainer.fit` on tpu_moe_8x1b at full width cut to 8 layers
           (f32 parameters, gradients and AdamW moments: 38.9 GB), B=8,
           S=2048, bf16 compute, save_attn remat: 2 warm-up and 5 measured
           steps on one repeated batch, 8 launches of each of B1-B3 a
           step, `loss_with_aux` falling; ms/step, tokens/s, MFU by
           `flops_per_token` (top-k experts; dispatch and combine not
           counted), peak memory, drop fraction
  moe_grads  tpu_moe_8x1b's widths at 2 layers, B=2, S=256, f32, TF32
           off: every gradient leaf on the card within 1e-3 relative L2
           of the CPU's; every token whose routing differs between the
           two at a near tie of router probabilities (the gaps reported);
           greedy `generate` tokens equal

  parallel_2rank  the tensor and pipe axes: two ranks share card 0 over
           gloo (NCCL refuses two ranks on one card; every time here is
           that arrangement's, host-staged, not a multi-GPU number), spawned
           by `parallel.launch.run_ranks` with a deadline.  Each collective's
           ms at 32 MiB and the route the shift takes.  tensor=2 at tpu_1b's
           full width and depth (8 heads, 2,752 d_ff columns and 16,000 vocab
           rows a rank), B=4 x 2048, bf16: one step's loss and every
           gradient leaf within 0.05 relative L2 of one rank on the card,
           then 1 + 2 steps on a repeated batch, 16 launches of each of
           B1-B3 a step and rank at q [4,8,2048,128], the loss falling;
           ms/step, tokens/s, MFU against one card, peak GB a rank.  pipe=2
           at full depth (8 layers a stage), B=8 x 2048, 4 microbatches,
           under GPipe and 1F1B: the same checks, 1 + 2 steps, launches a
           rank and step of 32/32/32 (GPipe) and 64/32/32 (1F1B re-runs
           each stage's forward in its backward); peak GB a rank at 8
           microbatches, 1F1B's below GPipe's.  In f32 at 2 layers with
           TF32 off: tensor, pipe (both schedules) and seq=2 (the ring
           through the shift) within 1e-3 of one rank, and two planted
           faults (x reaching the split head without `copy_to`; the
           head's gradient summed over pipe) flagged.  data=2 with 2
           accumulated microbatches at 2 layers: 3 steps with the
           overlapped sync and 3 without, losses equal bit for bit
  elastic_2rank  elastic training: two ranks share card 0 over gloo,
           each one slice (per-slice layout data=1, fsdp=1), their
           coordinators agreeing through a FileStore in the phase's
           directory.  tpu_1b at full width, 8 of its 16 layers (the
           depth cut for the script's time limit), global batch 8 x
           2048 (4 rows a rank at K=2, 8 at K=1), the train phase's
           configuration (bf16 params and moments, save_attn), a per-rank
           shard save every 2 steps; the step-4 save tears, slice 1 is
           lost at boundary 4 (its process leaves), rank 0 re-meshes to
           K=1 from the commit at step 2 and trains to step 6, slice 1
           returns as a new process, is handed the live state, and the
           job trains at K=2 to step 8.  Steps and slices as the
           reference's story; the K=1 losses equal to a fresh one-card
           trainer restored from step 2 (within twice the checkpoint
           phase's probe gap when that probe was not bitwise); both
           replicas' state bit for bit equal after the expand; 8 launches
           of each of B1-B3 a step and rank at both K (one a layer); the goodput buckets
           elastic_remesh and restart_replay > 0; room on disk for the
           shards.  ms/step at K=2 and K=1, the shrink's and the expand's
           seconds (wait, restore, the rest), the GB the shards write and
           read, the peak GB a rank.  Then the same story, shorter (lost
           at 2, back at 3, to step 4), at 2 layers of tpu_1b in f32, run
           twice at once: under the default rules and under rules that
           split the embedding over `data` (embed=("data", None)), whose
           expand hands the split leaves over block by block; every f32
           loss after the expand within 1e-5 relative of the default
           run's, both replicas' whole state equal, 2 launches of each of
           B1-B3 a step and process
  zoo_2rank  the other model families on a mesh: two ranks share card
           0 over gloo.  Mask R-CNN (maskrcnn_resnet50 at 512, the
           maskrcnn_coco recipe's configuration) at data=2, global batch
           8: one f32 step with TF32 off within 1e-3 of one process on the
           same batch (the loss and every leaf; BN's statistics over both
           ranks' images), the same step with BN on each rank's own
           statistics flagged; then 2 + 3 steps in bf16, exactly 2
           ROIAlign launches a rank and step and no other B1-B5, ms/step,
           peak GB a rank and one more step with the collectives timed.
           DLRM criteo_terabyte at fsdp=2, global batch 8,192 (the table
           stack's columns split, gathered for the lookup): one f32 step
           within 1e-3 of one process, then 1 + 2 bf16 steps, no B1-B5
           launch.  GraphSAGE at data=2 on 4,096-node blocks (neighbours
           read across the ranks): supervised and link prediction within
           1e-3 of one process, a rank reading only its own rows flagged
  runtime  the port as a cluster runtime: `ServingRuntime` (model tpu_1b,
           port 0) started on the port's in-memory state client answers
           /healthz, is listed by discovery on its bound port, answers one
           /v1/generate equal to its backend called in-process (no B1-B5
           launch: generation's attention is einsums, as in the
           reference), and deregisters at stop; the libraries
           `build_all()` made copied into a fresh directory; the command
           `AIRuntime.get_runnable_command` gives for this script (the port's
           launcher, `--nproc-per-node 1`) run with `--runtime-rank` and
           `TIK_COMPILE_CACHE_DIR` on that directory: the LoRA recipe's
           trainer at its defaults (tpu_1b, S=2048, B=8) for 1 warm-up and
           2 measured steps, building nothing (the compile bucket at 0),
           16 launches of each of B1-B3 a step; the same command on an
           empty directory without nvcc must fail with KernelBuildError;
           `AIRuntime.node_install` with torch present installs nothing
  hosts    the host as a cluster worker: `utils.resource_spec` run in fresh
           python3 processes that import nothing else of the port (no torch
           in `sys.modules`, and the card's free memory unchanged while the
           process lives: no CUDA context): its `GPU` against
           `torch.cuda.device_count()` here and its `accelerator_type`
           against `torch.cuda.get_device_name(0)`; its command-line form
           printing the same JSON; `CUDA_VISIBLE_DEVICES=""` giving no card
           and a planted `TIK_NODE_RESOURCES` given back exactly; the
           launcher's default `--nproc-per-node` equal to the count; the
           detection's milliseconds beside the `nvidia-smi` line
  observe  the port's serving metrics on the cluster's scrape path:
           `ServingRuntime` (the engine at tpu_1b, 8 slots) serving the
           port's registry on its telemetry port, the targets written by
           the port's `PrometheusRuntime.node_configure` and discovery
           `render_once`, the port's collector a subprocess scraping
           every 0.25 s; 16 requests of 32-700 tokens: the collector's
           summed TTFT count and ok-request count equal the answered
           requests, and `serve-ttft` has finite burns after >= 31 scrape
           cycles; the port's `serve-demand` policy over the live engine's
           heartbeat adds no `{"GPU": 1}` demand under 16 closed-loop
           clients, then, with a latency planted at `serve.decode_step`,
           `serve-ttft` turns firing and the policy adds one within its
           sustain cycles; the port's node exporter serving the node
           gauges under the port's catalog names; a corpus of >= 4 MB
           encoded by the port's tokenizer, a 3-step capture requested and
           a tpu_1b fit (B=8, S=2048, bf16, 1 + 3 steps) on that file
           whose trace holds 16 events of each of B1-B3 a captured step,
           served byte for byte by the port's profiler runtime's command;
           a scrape's ms, the SLO evaluation's ms, the capture's stop and
           export seconds, the trace's MB, the tokenizer's MB/s.  The
           port's CLI (`python -m cloudtik_tpu_torch.scripts.cli`, each a
           process where `import jax` raises): `cluster trace export`
           over the phase's targets holds one traced request's serve.*
           spans (enqueue, prefill, decode) under its trace id in the
           serving process's lane, `cluster trace summary` lists it;
           `serve requests --stats` counts every answered request in the
           phase's request ledger, `serve explain` finds the traced one,
           `events dump --trace-id` its one admission in the port's
           journal; and the port's `PrometheusRuntime` renders every http
           service of a cluster declaring `serving`, `consul`, `spark`
           and `grafana`
  control  the port's control plane on one machine: the native state
           server built by g++, the port's `ClusterController` over the
           virtual provider (nodes are local processes running the port's
           node agent, with the native host sampler) and the AI runtime's
           `AISliceScalingPolicy` asking `{"GPU": 1}` a pending job.  No
           launch in the ticks before the job; one `h100` host (the
           resources the port's detection reports) launched after it, as
           the scaler's decision journal says; the agent heartbeats,
           advertises the detection through the native sampler, holds no
           CUDA context (the card's free memory and its maps); the
           updater's start command runs the runtime phase's rank (1
           warm-up and 1 measured step, 16 launches of each of B1-B3 a
           step); the job marked done, the scaler terminates the host for
           `idle_timeout`, after the rank's result, and the agent's
           process group is gone; every python process of the phase ran
           with `import jax` and `import cloudtik_tpu` raising
  lifecycle  the README's quickstart through the port's CLI (`python -m
           cloudtik_tpu_torch.scripts.cli`, each call a process where
           `import jax` raises) on one virtual-provider cluster written
           from examples/serving-cluster.yaml: `validate`; `start -y`,
           whose daemonized node services boot the state server, the
           controller, the agents, nodex, the prometheus collector and the
           port's `ServingRuntime` (the engine at tpu_1b on the card);
           `status` (the head up-to-date); greedy requests to the
           discovered `serving` service (1 x 128 -> 32, then 2 concurrent
           x 64 -> 16), whose tokens are held to a direct `generate` on
           the same seed-0 params (equal but at a bf16 near tie) and,
           each one, by the engine phase's tie-aware check; `submit` of this script's rank (1 warm-up and 1
           measured step of the LoRA recipe at tpu_1b, 16 launches of
           each of B1-B3 a step by its own counts); `cluster trace
           export` (each request's serve spans once, in the head's
           `telemetry` lane) and the collector's counters (one count a
           request); `cluster-dump` (the bootstrap config, the
           node-services log, the journal with the boot and the
           requests' events); `chaos validate` and two `chaos run`s of
           one seeded plan (a launch failure, a delayed node listing)
           with equal traces; `stop` and a hard teardown: no process of
           the phase alive, the card's free memory back within 1 GiB, no
           node left
  local_provider  the control phase's loop over the `local` provider: the
           inventory is this machine (listed under the address its node
           agent reports), its claims in a file store under the phase's
           temporary directory, `auth.executor: local`.  No claim in the
           ticks before the job; one claim of the host after it, one
           `launch` decision; the worker's start command boots the host's
           node services (`node start --node-id <host> --daemonize`),
           whose agent advertises the card (`GPU` torch's count, an H100
           `accelerator_type`) through the native sampler and holds no
           CUDA context, then runs the control phase's rank (16 launches
           of each of B1-B3 a step); the claim released for `idle_timeout`
           after the rank's result, the store empty; the node services,
           which the release leaves running, stopped through the executor
           with `node stop`: every python process of the phase (each with
           `import jax` raising) gone and the card's free memory back
           within 1 GiB; a second provider over the same store claims the
           host again and releases it

Launch counts are zeroed just before each path (forward then serve; the
engine; spec; lora; disagg; fabric; the measured train steps; the resumed
steps of the checkpoint phase; the measured steps of lora_train and of
bert; the measured detect calls of each model; the measured steps of each
vision and model-zoo phase and its cross-device check; the loaders' fit;
the GBDT fit, serve and check; moe_serve's forward, server and engine;
moe_train's measured steps; in each rank of parallel_2rank, the
measured steps of the tensor and pipe paths; in each process of
elastic_2rank, its `fit_elastic`; in each rank of zoo_2rank, the
measured Mask R-CNN and DLRM steps; the serving runtime's start, request
and stop; in the runtime's rank, its measured steps; the hosts phase; the
observe phase's serving and its fit; in the control phase's rank, its
warm-up and its measured step; in the lifecycle phase's submitted rank
and the local_provider phase's rank, its warm-up and its measured step)
and read just after it.
The `total` line gives the script's seconds; the last lines are the
`nvidia-smi` name/power line, a `{"kernels": [...]}` summary and
`{"ok": true, "device": ...}`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

# Published dense peaks of one H100 SXM (NVIDIA data sheet) for the bound.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
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


# ------------------------------------------------------------------- build --

def ptxas_report(logs: dict) -> list:
    """Registers and spills of every kernel in nvcc's `-Xptxas -v` logs
    ({source: log}): one row per kernel, named `name<type, D>` where the
    mangled name allows."""
    rows = []
    for source, log in sorted(logs.items()):
        kernel = None
        for line in log.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                kernel = {"source": source,
                          "kernel": _kernel_name(m.group(1))}
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and kernel is not None:
                kernel["spill_stores"] = int(m.group(1))
                kernel["spill_loads"] = int(m.group(2))
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel is not None:
                kernel["registers"] = int(m.group(1))
                rows.append(kernel)
                kernel = None
    return rows


def _kernel_name(mangled: str) -> str:
    """`flash_fwd_kernel<__nv_bfloat16, 128>` from its mangled name, whose
    identifiers are length-prefixed (`20flash_bwd_dkv_kernel`)."""
    for m in re.finditer(r"(?=(\d{1,3})([A-Za-z_]\w*?_kernel))", mangled):
        if int(m.group(1)) != len(m.group(2)):
            continue
        rest = mangled[m.start() + len(m.group(1)) + len(m.group(2)):]
        t = re.match(r"I\d+(__nv_bfloat16|__half)Li(\d+)E", rest)
        return f"{m.group(2)}<{t.group(1)}, {t.group(2)}>" if t \
            else m.group(2)
    return mangled


# The main paths' flash kernels must not spill (bf16, D = 128).
NO_SPILL = tuple(f"{k}<__nv_bfloat16, 128>" for k in (
    "flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"))


# ------------------------------------------------------------------ kernel --

@dataclasses.dataclass(frozen=True)
class AttnCase:
    name: str
    B: int
    H: int
    Hkv: int
    S: int
    D: int
    causal: bool
    dtype: str = "bfloat16"
    # "bshd": [B,S,H,D] tensors transposed to BHSD, as the model hands them
    layout: str = "bhsd"
    # kv length, S when 0.  Causal with S != Skv is the kernels' absolute
    # mask (q_pos >= kv_pos), which the model reaches only through an
    # explicit implementation="flash"
    Skv: int = 0

    def __post_init__(self):
        if not self.Skv:
            object.__setattr__(self, "Skv", self.S)


# The first case is the shape and layout `forward` gives the kernel.  The
# others cover what the kernels tile: 128-row q tiles and 64-row kv tiles
# (forward, dq), 128-row kv tiles and 64-row q tiles (dk/dv), ragged ends, GQA,
# D = 64 and fp16.
ATTN_CASES = (
    AttnCase("forward_b4", 4, 16, 16, 2048, 128, True, layout="bshd"),
    AttnCase("tpu_1b_b1", 1, 16, 16, 2048, 128, True),
    AttnCase("gqa_noncausal", 2, 16, 4, 1024, 64, False),
    AttnCase("ragged_causal", 1, 16, 16, 1000, 128, True),
    AttnCase("fp16_causal", 1, 8, 8, 512, 128, True, dtype="float16"),
    AttnCase("cross_causal", 2, 16, 16, 384, 128, True, Skv=1024),
    AttnCase("d64_causal", 2, 16, 16, 2048, 64, True),
    AttnCase("gqa_causal", 2, 16, 4, 1024, 128, True, layout="bshd"),
    AttnCase("s1088_causal", 2, 16, 16, 1088, 128, True),
    # BERT-Large's attention as the bert phase hands it over: non-causal,
    # head_dim 64, S=512, q/k/v transposed views of [B, S, H, D]
    AttnCase("bert_large_b32", 32, 16, 16, 512, 64, False, layout="bshd"),
)
# bf16/fp16 output: p and o are rounded to 8/11 mantissa bits at different
# points in the kernel (per 64-column tile) and the plain version (per row)
O_ATOL, O_RTOL = 1e-2, 1e-2
# lse stays in f32; only the summation order differs
LSE_ATOL = 1e-3


def live_pairs(c: AttnCase) -> int:
    """Unmasked (q, kv) pairs of one head: causal under absolute positions,
    row q sees min(q + 1, Skv) keys."""
    if not c.causal:
        return c.S * c.Skv
    n = min(c.S, c.Skv)
    return n * (n + 1) // 2 + max(c.S - c.Skv, 0) * c.Skv


def attention_bound(c: AttnCase, elem_bytes: int = 2):
    """Least time for the work the inputs need: unmasked (q, kv) pairs
    only, each input read once, each output written once."""
    flops = 4 * c.B * c.H * live_pairs(c) * c.D
    nbytes = (elem_bytes * (2 * c.B * c.H * c.S * c.D
                            + 2 * c.B * c.Hkv * c.Skv * c.D)
              + 4 * c.B * c.H * c.S)
    t_ops = flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, bound_by, flops, nbytes


def _rand_heads(c: AttnCase, gen, heads: int, seq: int):
    import torch

    shape = (c.B, seq, heads, c.D) if c.layout == "bshd" \
        else (c.B, heads, seq, c.D)
    t = torch.randn(shape, generator=gen, device="cuda").to(
        getattr(torch, c.dtype))
    return t.transpose(1, 2) if c.layout == "bshd" else t


def make_qkv(c: AttnCase, gen):
    return (_rand_heads(c, gen, c.H, c.S),
            _rand_heads(c, gen, c.Hkv, c.Skv),
            _rand_heads(c, gen, c.Hkv, c.Skv))


def check_fwd(c: AttnCase, q, k, v, o, lse, scale: float) -> dict:
    """Hold the forward kernel's (o, lse) against the plain version on the
    same inputs; returns the largest errors."""
    import torch

    from cloudtik_tpu_torch.ops import flash_attention as FA

    if q.is_cuda:
        torch.cuda.synchronize()
    o_ref, lse_ref = FA.flash_attention_reference(
        q, k, v, causal=c.causal, sm_scale=scale)
    o_err = (o.float() - o_ref.float()).abs()
    o_ok = bool((o_err <= O_ATOL + O_RTOL * o_ref.float().abs()).all())
    lse_err = (lse - lse_ref).abs().max().item()
    require(o.shape == q.shape and lse.shape == (c.B, c.H, c.S, 1),
            f"{c.name}: output shapes {tuple(o.shape)}, {tuple(lse.shape)}")
    require(bool(torch.isfinite(o).all()), f"{c.name}: non-finite o")
    require(o_ok, f"{c.name}: o differs from the plain version "
                  f"(max abs {o_err.max().item()})")
    require(lse_err <= LSE_ATOL, f"{c.name}: lse differs by {lse_err}")
    return {"o_max_abs_err": o_err.max().item(), "lse_max_abs_err": lse_err}


def phase_kernel() -> dict:
    import torch
    import torch.nn.functional as F

    from cloudtik_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for c in ATTN_CASES:
        q, k, v = make_qkv(c, gen)
        scale = c.D ** -0.5
        o, lse = FA.flash_attention_fwd(q, k, v, causal=c.causal,
                                        sm_scale=scale)
        fwd_errors = check_fwd(c, q, k, v, o, lse, scale)
        kernel_ms = time_ms(lambda: FA.flash_attention_fwd(
            q, k, v, causal=c.causal, sm_scale=scale))
        plain_ms = time_ms(lambda: FA.flash_attention_reference(
            q, k, v, causal=c.causal, sm_scale=scale), iters=3)
        gqa = {"enable_gqa": True} if c.H != c.Hkv else {}
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=c.causal, scale=scale, **gqa))
        bound_ms, bound_by, flops, nbytes = attention_bound(c)
        row = {
            "case": c.name, "shape_q": list(q.shape), "hkv": c.Hkv,
            "skv": c.Skv, "causal": c.causal, "dtype": c.dtype,
            "layout": c.layout, **fwd_errors,
            "tolerance": {"o_atol": O_ATOL, "o_rtol": O_RTOL,
                          "lse_atol": LSE_ATOL},
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "flops": flops, "bytes": nbytes,
            "tflops_per_s": flops / kernel_ms / 1e9,
        }
        emit("kernel", **row)
        results.append(row)
        del q, k, v, o, lse
        torch.cuda.empty_cache()
    return {r["case"]: r for r in results}


# -------------------------------------------------------------- kernel_bwd --

# The first case is the shape and layout the training path gives the
# kernels (tpu_1b at B=8, S=2048; do arrives in o's layout).
BWD_CASES = (
    AttnCase("train_b8", 8, 16, 16, 2048, 128, True, layout="bshd"),
) + ATTN_CASES[1:]
# bf16/fp16 gradients: p and ds are rounded to 8/11 mantissa bits before
# their products in both versions, but from f32 scores summed in another
# order, so a rounding may flip; dk/dv sum up to S such terms.  Held per
# element at 2e-2 + 2e-2 |ref| and as a whole at 1e-2 relative L2.
GRAD_ATOL, GRAD_RTOL, GRAD_REL_L2 = 2e-2, 2e-2, 1e-2


def attention_bwd_bound(c: AttnCase, elem_bytes: int = 2) -> dict:
    """Least time of each backward kernel for the work its inputs need:
    unmasked (q, kv) pairs only (dq: 3 products, 6 * pairs * D flops per
    (b, h); dk/dv: 4 products, 8 * pairs * D), each input read once (q,
    k, v, do, and lse and delta in f32), each output written once."""
    pairs = live_pairs(c)
    q_elems = c.B * c.H * c.S * c.D
    kv_elems = c.B * c.Hkv * c.Skv * c.D
    stats = 2 * 4 * c.B * c.H * c.S
    inputs = elem_bytes * (2 * q_elems + 2 * kv_elems) + stats
    out = {}
    for name, per_pair, written in (("dq", 6, q_elems),
                                    ("dkv", 8, 2 * kv_elems)):
        flops = per_pair * c.B * c.H * pairs * c.D
        nbytes = inputs + elem_bytes * written
        t_ops = flops / PEAK_BF16_FLOPS
        t_bytes = nbytes / PEAK_BYTES_PER_S
        out[name] = {"bound_ms": max(t_ops, t_bytes) * 1e3,
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes", "flops": flops, "bytes": nbytes}
    return out


def _grad_errors(got, want) -> dict:
    err = (got.float() - want.float())
    ref = want.float()
    return {"max_abs": err.abs().max().item(),
            "rel_l2": (err.norm() / ref.norm()).item(),
            "within": bool((err.abs() <= GRAD_ATOL
                            + GRAD_RTOL * ref.abs()).all()),
            "finite": bool(_all_finite(got))}


def _all_finite(t) -> bool:
    import torch

    return bool(torch.isfinite(t).all())


def phase_kernel_bwd() -> dict:
    import torch
    import torch.nn.functional as F

    from cloudtik_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(1)
    results = []
    for c in BWD_CASES:
        q, k, v = make_qkv(c, gen)
        do = _rand_heads(c, gen, c.H, c.S)
        scale = c.D ** -0.5
        o, lse = FA.flash_attention_fwd(q, k, v, causal=c.causal,
                                        sm_scale=scale)
        # the backward reads the forward's o and lse: hold them first
        fwd_errors = check_fwd(c, q, k, v, o, lse, scale)
        dq, dk, dv = FA.flash_attention_bwd(q, k, v, o, lse, do,
                                            causal=c.causal, sm_scale=scale)
        torch.cuda.synchronize()
        want = FA.flash_attention_bwd_reference(
            q, k, v, o, lse, do, causal=c.causal, sm_scale=scale)
        errors = {n: _grad_errors(g, w)
                  for n, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
        del want
        for n, e in errors.items():
            require(e["finite"], f"{c.name}: non-finite {n}")
            require(e["within"] and e["rel_l2"] <= GRAD_REL_L2,
                    f"{c.name}: {n} differs from the plain version {e}")
        require(dq.shape == q.shape and dk.shape == k.shape
                and dv.shape == v.shape, f"{c.name}: gradient shapes")
        delta = FA._bwd_delta(o, do)
        dq_ms = time_ms(lambda: FA._launch_dq(
            q, k, v, do, lse, delta, c.causal, scale))
        dkv_ms = time_ms(lambda: FA._launch_dkv(
            q, k, v, do, lse, delta, c.causal, scale))
        bwd_ms = time_ms(lambda: FA.flash_attention_bwd(
            q, k, v, o, lse, do, causal=c.causal, sm_scale=scale))
        plain_ms = time_ms(lambda: FA.flash_attention_bwd_reference(
            q, k, v, o, lse, do, causal=c.causal, sm_scale=scale), iters=3)
        # yardstick: SDPA forward+backward minus SDPA forward
        gqa = {"enable_gqa": True} if c.H != c.Hkv else {}
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=c.causal, scale=scale,
                **gqa).backward(do)

        with torch.no_grad():
            sdpa_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=c.causal, scale=scale, **gqa))
        sdpa_bwd_ms = time_ms(sdpa_fwd_bwd) - sdpa_fwd_ms
        bound = attention_bwd_bound(c)
        row = {
            "case": c.name, "shape_q": list(q.shape), "hkv": c.Hkv,
            "skv": c.Skv, "causal": c.causal, "dtype": c.dtype,
            "layout": c.layout, "errors": errors, "fwd_errors": fwd_errors,
            "tolerance": {"o_atol": O_ATOL, "o_rtol": O_RTOL,
                          "lse_atol": LSE_ATOL,
                          "atol": GRAD_ATOL, "rtol": GRAD_RTOL,
                          "rel_l2": GRAD_REL_L2, "why": (
                              "p and ds rounded to the input type before "
                              "their products in both versions, from f32 "
                              "scores summed in another order")},
            "dq": {"kernel_ms": dq_ms, **bound["dq"],
                   "tflops_per_s": bound["dq"]["flops"] / dq_ms / 1e9},
            "dkv": {"kernel_ms": dkv_ms, **bound["dkv"],
                    "tflops_per_s": bound["dkv"]["flops"] / dkv_ms / 1e9},
            "bwd_ms": bwd_ms,
            "plain_ms": plain_ms,
            "plain_is": "flash_attention_bwd_reference: dq, dk, dv together",
            "library_ms": sdpa_bwd_ms,
            "library_is": "SDPA forward+backward minus SDPA forward "
                          "(dq, dk, dv together)",
        }
        emit("kernel_bwd", **row)
        results.append(row)
        del q, k, v, do, o, lse, dq, dk, dv, qs, ks, vs, delta
        torch.cuda.empty_cache()
    return {r["case"]: r for r in results}


# ------------------------------------------------------------ kernel_paged --

@dataclasses.dataclass(frozen=True)
class PagedCase:
    name: str
    B: int
    H: int
    Hkv: int
    D: int
    bs: int
    M: int
    lengths: tuple        # each lane's appended position (attends 0..len)


def _spread(lo: int, hi: int, n: int) -> tuple:
    return tuple(lo + (hi - lo) * i // (n - 1) for i in range(n))


# Mistral-7B in mistral7b-serve-chat: 32 lanes of 64 blocks of 16; lanes
# holding 103-986 positions (its prompts and outputs), and all full
PAGED_CASES = (
    PagedCase("chat_spread", 32, 32, 8, 128, 16, 64, _spread(102, 985, 32)),
    PagedCase("chat_full", 32, 32, 8, 128, 16, 64, (1023,) * 32),
)
# bf16 output: both versions round an f32 result once, from sums taken in
# another order, so the rounding may move by one bf16 step (2**-7 of the
# value at most), with a floor for values near 0
PAGED_RTOL, PAGED_ATOL = 2.0 ** -7, 1e-5


def paged_bound(c: PagedCase, elem_bytes: int = 2):
    """Least time for what the inputs need: each lane's K/V of positions
    0..len - 1 read once, q and the new k/v read, the append and the
    output written, the tables, lengths and mask read."""
    flops = 4 * sum(n + 1 for n in c.lengths) * c.H * c.D
    kv = 2 * sum(c.lengths) * c.Hkv * c.D
    nbytes = (elem_bytes * (kv + c.B * c.H * c.D * 2
                            + 2 * 2 * c.B * c.Hkv * c.D)
              + 8 * c.B * c.M + 9 * c.B)
    t_ops = flops / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, bound_by, flops, nbytes


def graph_time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one fn() from a CUDA graph of `iters` calls, replayed
    `reps` times between CUDA events: the kernels back to back, with no
    host enqueue between them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def paged_inputs(c: PagedCase, gen):
    """bf16 inputs of case `c`: each lane's own blocks from a shuffled
    pool of B * M + 1, every lane active."""
    import torch

    N = c.B * c.M + 1

    def t(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    tables = (torch.randperm(N - 1, generator=gen, device="cuda") + 1
              ).reshape(c.B, c.M)
    return (t(c.B, 1, c.H, c.D), t(c.B, 1, c.Hkv, c.D),
            t(c.B, 1, c.Hkv, c.D), t(N, c.bs, c.Hkv, c.D),
            t(N, c.bs, c.Hkv, c.D), tables,
            torch.tensor(c.lengths, dtype=torch.int64, device="cuda"),
            torch.ones(c.B, dtype=torch.bool, device="cuda"))


def phase_kernel_paged(cases=PAGED_CASES) -> dict:
    import torch

    from cloudtik_tpu_torch.ops import paged_attention as PA

    gen = torch.Generator(device="cuda").manual_seed(6)
    results = []
    for c in cases:
        args = paged_inputs(c, gen)
        twin = [a.clone() for a in args]
        before = PA.LAUNCHES
        o = PA.paged_attention(*args, c.bs)
        launches = PA.LAUNCHES - before
        want = PA.paged_attention_reference(*twin, c.bs)
        torch.cuda.synchronize()
        err = (o.float() - want.float()).abs()
        require(bool((err <= PAGED_ATOL + PAGED_RTOL
                      * want.float().abs()).all()),
                f"{c.name}: paged attention differs from the plain version "
                f"(max abs {err.max().item()})")
        require(torch.equal(args[3][1:], twin[3][1:])
                and torch.equal(args[4][1:], twin[4][1:]),
                f"{c.name}: the kernel's append differs from the plain "
                "version's")
        _, n_splits = PA.split_plan(c.B, c.Hkv, c.M * c.bs,
                                    PA._sm_count(o.device))
        require(launches == (1 if n_splits == 1 else 2),
                f"{c.name}: {launches} launches for {n_splits} splits")
        kernel_ms = graph_time_ms(lambda: PA.paged_attention(*args, c.bs))
        eager_ms = time_ms(lambda: PA.paged_attention(*args, c.bs))
        plain_ms = time_ms(lambda: PA.paged_attention_reference(
            *twin, c.bs), iters=3)
        bound_ms, bound_by, flops, nbytes = paged_bound(c)
        row = {
            "case": c.name, "lanes": c.B, "heads": c.H, "kv_heads": c.Hkv,
            "head_dim": c.D, "block": c.bs, "table_slots": c.M,
            "positions": [min(c.lengths) + 1, max(c.lengths) + 1],
            "mean_positions": sum(c.lengths) / c.B + 1,
            "splits": n_splits, "launches": launches,
            "max_abs_err": err.max().item(),
            "tolerance": {"rtol": PAGED_RTOL, "atol": PAGED_ATOL},
            "kernel_ms": kernel_ms, "eager_ms": eager_ms,
            "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
            "bytes": nbytes, "tb_per_s": nbytes / kernel_ms / 1e9,
        }
        emit("kernel_paged", **row)
        results.append(row)
        del args, twin, o, want
        torch.cuda.empty_cache()
    return {r["case"]: r for r in results}


# ----------------------------------------------------------------- serving --

def _http(url: str, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def phase_serve(model: str = "tpu_1b", device: str = "cuda") -> dict:
    import numpy as np
    import torch

    from cloudtik_tpu_torch.models import generate as G
    from cloudtik_tpu_torch.serve.server import ServeServer, \
        transformer_backend

    backend = transformer_backend(model, device=device)
    cfg, params = backend.cfg, backend.params
    V = cfg.vocab_size
    server = ServeServer([backend], host="127.0.0.1", port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    rng = np.random.default_rng(0)
    out = {}
    try:
        require(_http(base + "/healthz") == (200, {"status": "ok"}),
                "healthz")
        require(_http(base + "/v1/models")[1]["models"]
                == [f"transformer:{model}"], "models")
        # warm-up: first cuBLAS/allocator use, not timed
        status, _ = _http(base + "/v1/generate",
                          {"tokens": [[1, 2, 3]], "max_new_tokens": 2})
        require(status == 200, f"warm-up status {status}")

        for name, batch, plen, new in (("greedy_b1", 1, 128, 32),
                                       ("greedy_b2", 2, 64, 16)):
            prompt = rng.integers(0, V, (batch, plen)).tolist()
            t0 = time.perf_counter()
            status, body = _http(base + "/v1/generate",
                                 {"tokens": prompt, "max_new_tokens": new})
            wall = time.perf_counter() - t0
            require(status == 200, f"{name}: status {status} {body}")
            toks = np.asarray(body["tokens"])
            require(toks.shape == (batch, new), f"{name}: shape {toks.shape}")
            require(bool(((toks >= 0) & (toks < V)).all()), f"{name}: ids")
            direct = G.generate(
                params, torch.tensor(prompt, device=device), cfg,
                max_new_tokens=new).cpu().numpy()
            require(bool((direct == toks).all()),
                    f"{name}: served tokens differ from direct generate")
            out[name] = {"batch": batch, "prompt": plen, "new": new,
                         "wall_s": wall,
                         "tokens_per_s": batch * new / wall,
                         "equals_direct_generate": True}

        prompt = rng.integers(0, V, (1, 16)).tolist()
        topk = {"tokens": prompt, "max_new_tokens": 8, "temperature": 1.0,
                "top_k": 40, "seed": 7}
        s1, b1 = _http(base + "/v1/generate", topk)
        s2, b2 = _http(base + "/v1/generate", topk)
        require(s1 == s2 == 200, f"top-k status {s1} {s2}")
        require(b1 == b2, "top-k: same seed gave different tokens")
        direct = G.generate(
            params, torch.tensor(prompt, device=device), cfg,
            max_new_tokens=8, temperature=1.0, top_k=40,
            generator=torch.Generator(device=device).manual_seed(7))
        require(direct.cpu().tolist() == b1["tokens"],
                "top-k: served tokens differ from direct generate")
        out["topk_seeded"] = {"tokens": b1["tokens"], "repeatable": True}

        bad = [_http(base + "/v1/generate", p)[0] for p in (
            {"tokens": [[V]]}, {"tokens": "abc"}, {"max_new_tokens": 2})]
        require(bad == [400, 400, 400], f"400 path gave {bad}")
        require(_http(base + "/nope")[0] == 404, "404 path")
        require(server.drain(grace_s=5.0), "drain")
        status, _ = _http(base + "/v1/generate",
                          {"tokens": [[1]], "max_new_tokens": 1})
        require(status == 503, f"drained server answered {status}")
        out["error_paths"] = {"bad_request": bad, "not_found": 404,
                              "draining": status}
    finally:
        server.stop()
    emit("serve", **out)
    del backend, params
    return out


# ------------------------------------------------------------------ engine --

# Tie-aware greedy: each token the engine emits must have a logit within
# ENGINE_TIE_GAP of the largest at its position, by one teacher-forced
# `forward_step` over the prompt and the emitted tokens.  cuBLAS picks its
# kernels by shape, so the engine's B=8 decode and bucketed prefill need not
# round like `generate` at B=1, and a near tie may go either way; a lane that
# read another slot's KV shows as gaps of order 1 and more.
ENGINE_TIE_GAP = 0.1
# The logits check: every decode step's logits, as the engine computed them,
# within ENGINE_LOGITS_MAX_ABS of the teacher-forced ones at that position.
# At random weights the top logits crowd together, so a token that a wrong
# context chose may still sit within ENGINE_TIE_GAP of the top; this check
# holds every entry of every row.  On the H100 at tpu_1b the spread was
# 0.062 (wave and oversubscribed run), while a planted fault's weakest lane
# differed by 0.46 (lengths rolled; its tie gap only 0.17) and 3.6 (tables
# rolled): the limit sits 2.4x above the one and 3x below the other.
ENGINE_LOGITS_MAX_ABS = 0.15


@dataclasses.dataclass(frozen=True)
class EngineLoad:
    """The engine phase's configuration and traffic.  Request i asks for a
    prompt of prompt_lens[i % 4] tokens of its own; the even-numbered ones
    open with one shared prefix_len-token prefix first (a system prompt,
    cached by the warm-up request before the wave); requests with
    i % 4 == 1 ask for short_new tokens, the others for new_tokens."""
    slots: int = 8
    max_len: int = 1024
    block_size: int = 16
    prompt_lens: tuple = (32, 128, 384, 700)
    prefix_len: int = 256
    clients: int = 16
    new_tokens: int = 64
    short_new: int = 16
    oversize_prompt: int = 1100
    # the oversubscribed run: 3 requests' worth of blocks for `slots`
    # requests whose prompts alone take every block
    over_prompt: int = 384
    over_new: int = 64
    min_full_steps: int = 20


ENGINE_LOAD = EngineLoad()
# the CPU rehearsal at `tiny`: the same traffic at a quarter of the lengths
REHEARSAL_LOAD = EngineLoad(
    max_len=256, block_size=8, prompt_lens=(8, 32, 96, 175), prefix_len=64,
    new_tokens=16, short_new=6, oversize_prompt=300, over_prompt=96,
    over_new=16, min_full_steps=1)


def teacher_logits(params, cfg, prompt, tokens, device):
    """[len(tokens), vocab] f32: row k is the logits that choose tokens[k],
    by one teacher-forced forward over prompt + tokens."""
    import torch

    from cloudtik_tpu_torch.models import generate as G

    seq = list(prompt) + list(tokens[:-1])
    cache = G.init_cache(cfg, 1, len(seq), device)
    with torch.no_grad():
        logits, _ = G.forward_step(
            params, torch.tensor([seq], device=device), cache, cfg)
    return logits[0, len(prompt) - 1:]


def tie_gaps(params, cfg, prompt, tokens, device, teacher=None) -> list:
    """For each emitted token, the largest logit at its position less the
    token's own, teacher-forced."""
    import torch

    pos = teacher_logits(params, cfg, prompt, tokens, device) \
        if teacher is None else teacher
    chosen = pos.gather(-1, torch.tensor(tokens, device=device)[:, None])
    return (pos.max(-1).values - chosen[:, 0]).tolist()


class StepLogits:
    """Records, while entered, the logits of every decode step of `engine`
    as its `decode_step` computed them: `rows(request_id)[k]` is the row
    that chose that request's tokens[k].  `fault` plants a fault for the
    checks' power run: "tables" or "lengths" hands the step that tensor
    rolled one lane on, as a lane reading another slot's KV or offset
    would; "adapters" rolls a gathered LoRA step's adapter indices one
    lane on, as a lane decoding under another lane's adapter would, and
    `changed(request_id)` says whether that moved the request's own."""

    FAULTS = ("tables", "lengths")

    def __init__(self, engine, fault: str = None):
        require(fault in (None, "adapters") + self.FAULTS,
                f"unknown fault {fault}")
        self.engine, self.fault, self._steps = engine, fault, []
        self._changed = set()

    def __enter__(self):
        from cloudtik_tpu_torch.serve import engine as E

        self._module, self._orig = E, E.decode_logits

        def decode_logits(params, tokens, kp, vp, tables, lengths, active,
                          cfg, block_size, lora=None, attn_timer=None):
            if kp is not self.engine._kp:
                return self._orig(params, tokens, kp, vp, tables, lengths,
                                  active, cfg, block_size, lora=lora,
                                  attn_timer=attn_timer)
            lanes = [(b, s.request.request_id, len(s.request.tokens))
                     for b, s in enumerate(self.engine._slots)
                     if s is not None and s.decoding]
            if self.fault == "tables":
                tables = tables.roll(1, 0)
            elif self.fault == "lengths":
                lengths = lengths.roll(1, 0)
            elif self.fault == "adapters" and lora is not None:
                rolled = lora["idx"].roll(1, 0)
                moved = (lora["idx"] != rolled).tolist()
                self._changed.update(rid for b, rid, _ in lanes
                                     if moved[b])
                lora = dict(lora, idx=rolled)
            out = self._orig(params, tokens, kp, vp, tables, lengths,
                             active, cfg, block_size, lora=lora,
                             attn_timer=attn_timer)
            self._steps.append((out.clone(), lanes))
            return out

        E.decode_logits = decode_logits
        return self

    def __exit__(self, *exc):
        self._module.decode_logits = self._orig

    def rows(self, request_id) -> dict:
        # a preempted request decodes a position again: the last one counts
        return {k: logits[b] for logits, lanes in self._steps
                for b, rid, k in lanes if rid == request_id}

    def changed(self, request_id) -> bool:
        return request_id in self._changed


class VerifyLogits:
    """Records, while entered, the logits of every speculative verify of
    `engine`: `rows(request)[k]` is the verify row that scored the
    request's tokens[k], for each row whose input was the request's own
    sequence (the pending token and the proposals accepted before it), so
    rows after a rejected proposal are left out.  `fault="shift"` runs the
    verify one position on (`start + 1`), as a verify writing and reading
    at a wrong cursor would."""

    def __init__(self, engine, fault: str = None):
        require(fault in (None, "shift"), f"unknown fault {fault}")
        self.engine, self.fault, self._rounds = engine, fault, []

    def __enter__(self):
        from cloudtik_tpu_torch.models import generate as G

        self._module, self._orig = G, G.paged_verify
        spec_step = self.engine._spec_step
        current = {}

        def tagged_spec_step(slot_id, slot):
            current["request"] = slot.request
            return spec_step(slot_id, slot)

        def paged_verify(params, kp, vp, table, tokens, start, cfg):
            out = self._orig(params, kp, vp, table, tokens,
                             start + (self.fault == "shift"), cfg)
            self._rounds.append((current["request"], start,
                                 tokens[0].tolist(), out[2][0].clone()))
            return out

        self.engine._spec_step = tagged_spec_step
        G.paged_verify = paged_verify
        return self

    def __exit__(self, *exc):
        self._module.paged_verify = self._orig
        del self.engine._spec_step

    def rows(self, req) -> dict:
        out = {}
        for r, start, inputs, logits in self._rounds:
            if r is not req:
                continue
            k0 = start - len(req.prompt) + 1   # tokens[k0 - 1] is pending
            for i in range(len(inputs)):
                if k0 + i >= len(req.tokens) \
                        or inputs[i] != req.tokens[k0 - 1 + i]:
                    break
                out[k0 + i] = logits[i]
        return out

    def rounds(self, req) -> int:
        return sum(r is req for r, *_ in self._rounds)


def logits_diff(teacher, rows: dict) -> float:
    """The largest |engine - teacher| over every recorded step's logits."""
    require(rows, "no decode step was recorded")
    return max(float((row - teacher[k]).abs().max())
               for k, row in rows.items())


def greedy_margins(params, cfg, prompt, tokens, device) -> list:
    """Top-1 less top-2 logit at each of `tokens`' positions (the direct
    greedy path's own tokens), teacher-forced."""
    import torch

    top = torch.topk(teacher_logits(params, cfg, prompt, tokens, device),
                     2, dim=-1).values
    return (top[:, 0] - top[:, 1]).tolist()


def check_tie_aware(name: str, gaps: list) -> float:
    worst = max(gaps)
    require(worst <= ENGINE_TIE_GAP,
            f"{name}: an emitted token's logit is {worst} below the "
            f"largest at its position (limit {ENGINE_TIE_GAP})")
    return worst


def generate_teacher(params, cfg, prompt, tokens, device, pinned=None):
    """[len(tokens), vocab] f32 as `generate` computes them: the prompt's
    prefill, then one step per emitted token (teacher-forced).  The
    teacher of a MoE model, whose routing groups are each call's rows:
    one forward over prompt + tokens would route the whole sequence at
    once, and neither `generate` nor the engine does.  `pinned`: for each
    of those calls, every MoE layer's router probabilities to route by
    (`EngineRoutes.calls`) instead of its own."""
    import torch

    from cloudtik_tpu_torch.models import generate as G
    from cloudtik_tpu_torch.ops import moe as TM

    real, seen = TM.router_probs, []

    def pinned_probs(x, w):
        probs, logits = real(x, w)
        call, layer = divmod(len(seen), cfg.n_layers)
        seen.append(1)
        return pinned[call][layer].to(probs.device), logits

    if pinned is not None:
        TM.router_probs = pinned_probs
    cache = G.init_cache(cfg, 1, len(prompt) + len(tokens), device)
    rows = []
    try:
        with torch.no_grad():
            logits, _ = G.forward_step(
                params, torch.tensor([list(prompt)], device=device), cache,
                cfg)
            rows.append(logits[0, -1])
            for t in tokens[:-1]:
                logits, _ = G.forward_step(
                    params, torch.tensor([[t]], device=device), cache, cfg)
                rows.append(logits[0, -1])
    finally:
        TM.router_probs = real
    return torch.stack(rows)


class EngineRoutes:
    """Records, while entered, the router probabilities of every MoE call
    `engine` makes: each prefill chunk's (with its tokens and start) and
    each decode step's (with its lanes, as StepLogits numbers them).  In
    bf16 a token near a routing tie may route otherwise in the engine's
    B=slots step than in a B=1 teacher and change its logits whole, which
    says nothing of the engine's KV; a teacher pinned to the engine's own
    routes (`calls`) leaves only that."""

    def __init__(self, engine):
        self.engine, self.prefills, self.steps = engine, [], []

    def __enter__(self):
        from cloudtik_tpu_torch.models import generate as G
        from cloudtik_tpu_torch.ops import moe as TM
        from cloudtik_tpu_torch.serve import engine as E

        self._mods = (TM, G, E)
        self._orig = (TM.router_probs, G.paged_prefill_chunk,
                      E.decode_logits)
        current = []

        def router_probs(x, w):
            probs, logits = self._orig[0](x, w)
            current.append(probs.detach().clone())
            return probs, logits

        def prefill(params, kp, vp, table, tokens, start, cfg, lora=None):
            current.clear()
            out = self._orig[1](params, kp, vp, table, tokens, start, cfg,
                                lora=lora)
            self.prefills.append((tokens[0].tolist(), int(start),
                                  list(current)))
            return out

        def decode(params, tokens, kp, vp, tables, lengths, active, cfg,
                   block_size, lora=None, attn_timer=None):
            lanes = [(b, s.request.request_id, len(s.request.tokens))
                     for b, s in enumerate(self.engine._slots)
                     if s is not None and s.decoding]
            current.clear()
            out = self._orig[2](params, tokens, kp, vp, tables, lengths,
                                active, cfg, block_size, lora=lora,
                                attn_timer=attn_timer)
            self.steps.append((lanes, list(current)))
            return out

        TM.router_probs, G.paged_prefill_chunk, E.decode_logits = (
            router_probs, prefill, decode)
        return self

    def __exit__(self, *exc):
        TM, G, E = self._mods
        TM.router_probs, G.paged_prefill_chunk, E.decode_logits = self._orig

    def calls(self, prompt, request_id, n_tokens) -> list:
        """The routes of `generate_teacher`'s calls for one answer: the
        prompt's prefill (one chunk from position 0), then the decode step
        that chose each token after the first."""
        pre = [probs for toks, start, probs in self.prefills
               if start == 0 and toks == list(prompt)]
        require(len(pre) == 1, f"request {request_id}: {len(pre)} one-chunk "
                "prefills of its prompt recorded, expected 1")
        steps = {k: [p[b:b + 1] for p in probs]
                 for lanes, probs in self.steps
                 for b, rid, k in lanes if rid == request_id}
        missing = [k for k in range(1, n_tokens) if k not in steps]
        require(not missing, f"request {request_id}: no decode step "
                f"recorded for tokens {missing}")
        return pre + [steps[k] for k in range(1, n_tokens)]


def check_answer(name, params, cfg, prompt, tokens, recorder, request_id,
                 device, teacher_fn=teacher_logits) -> tuple:
    """The tie-aware greedy check and the logits check of one answer;
    returns (largest tie gap, largest logits difference)."""
    teacher = teacher_fn(params, cfg, prompt, tokens, device)
    gap = check_tie_aware(name, tie_gaps(params, cfg, prompt, tokens,
                                         device, teacher))
    diff = logits_diff(teacher, recorder.rows(request_id))
    require(diff <= ENGINE_LOGITS_MAX_ABS,
            f"{name}: a decode step's logits are {diff} from the "
            f"teacher-forced ones (limit {ENGINE_LOGITS_MAX_ABS})")
    return gap, diff


def planted_fault(params, cfg, load, prompts, fault: str,
                  device) -> dict:
    """The checks' power at the phase's own shape: `load.slots` requests of
    `prompts` through an engine whose decode step gets its block tables or
    lengths rolled one lane on (`fault` None: neither).  Returns, over the
    lanes, the smallest of each lane's largest tie gap and logits
    difference, and how many lanes each check flags."""
    from cloudtik_tpu_torch.serve.engine import (
        DecodeEngine, EngineConfig, Request)

    eng = DecodeEngine(params, cfg, EngineConfig(
        slots=load.slots, max_len=load.max_len,
        block_size=load.block_size), device=device)
    reqs = [eng.submit(Request(p, max_new_tokens=load.short_new))
            for p in prompts[:load.slots]]
    with StepLogits(eng, fault) as rec:
        eng.start()
        try:
            outs = [r.wait(timeout=600) for r in reqs]
        finally:
            eng.stop()
    gaps, diffs = [], []
    for r, toks in zip(reqs, outs):
        teacher = teacher_logits(params, cfg, r.prompt, toks, device)
        gaps.append(max(tie_gaps(params, cfg, r.prompt, toks, device,
                                 teacher)))
        diffs.append(logits_diff(teacher, rec.rows(r.request_id)))
    return {"fault": fault, "lanes": len(reqs),
            "tie_gap_min_lane": min(gaps),
            "lanes_flagged_by_tie_gap": sum(g > ENGINE_TIE_GAP
                                            for g in gaps),
            "logits_diff_min_lane": min(diffs),
            "lanes_flagged_by_logits": sum(d > ENGINE_LOGITS_MAX_ABS
                                           for d in diffs)}


def _percentiles(values: list) -> dict:
    import numpy as np

    return {"p50": float(np.percentile(values, 50)),
            "p95": float(np.percentile(values, 95))}


def engine_traffic(params, cfg, load: EngineLoad, device,
                   direct_new: int = None) -> dict:
    """The engine phase's requests, from numpy seed 0: `load.clients`
    prompts (the even ones behind one shared `load.prefix_len`-token
    prefix) and their new-token counts; each prompt's direct greedy
    answer (its first `direct_new` tokens when given); and the EOS
    request, the one whose first five direct tokens lead their runners-up
    by the most, so its stop position does not hang on a near tie, with
    its EOS token.  `rng` goes on drawing for the phase."""
    import numpy as np
    import torch

    from cloudtik_tpu_torch.models import generate as G

    L, V = load, cfg.vocab_size
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, V, L.prefix_len).tolist()
    prompts, news = [], []
    for i in range(L.clients):
        own = rng.integers(0, V, L.prompt_lens[i % 4]).tolist()
        prompts.append(prefix + own if i % 2 == 0 else own)
        news.append(L.short_new if i % 4 == 1 else L.new_tokens)
    direct = [G.generate(params, torch.tensor([p], device=device), cfg,
                         max_new_tokens=min(n, direct_new or n))[0].tolist()
              for p, n in zip(prompts, news)]
    margins = [min(greedy_margins(params, cfg, p, d[:5], device))
               if d[4] not in d[:4] else -1.0
               for p, d in zip(prompts, direct)]
    eos_i = int(np.argmax(margins))
    return {"rng": rng, "prefix": prefix, "prompts": prompts, "news": news,
            "direct": direct, "margins": margins, "eos_i": eos_i,
            "eos": direct[eos_i][4]}


def phase_engine(model: str = "tpu_1b", device: str = "cuda",
                 load: EngineLoad = ENGINE_LOAD,
                 nvidia_smi: str = None) -> dict:
    """`tik-serve --engine`'s backend at `model` width behind ServeServer:
    one warm-up request, then `load.clients` concurrent HTTP clients; the
    413 and cancel paths; then an oversubscribed direct DecodeEngine that
    must preempt.  Every result passes the tie-aware greedy check."""
    import tempfile
    import threading

    import torch

    from cloudtik_tpu_torch import telemetry
    from cloudtik_tpu_torch.serve import kvcache, reqlog
    from cloudtik_tpu_torch.serve.engine import (
        DecodeEngine, EngineConfig, Request, RequestCancelled)
    from cloudtik_tpu_torch.serve.server import ServeServer, engine_backend
    from cloudtik_tpu_torch.telemetry import instruments as ti

    on_card = device == "cuda"
    L = load
    telemetry.enable()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    backend = engine_backend(model, slots=L.slots, max_len=L.max_len,
                             block_size=L.block_size, device=device)
    engine, cfg, params = backend.engine, backend.cfg, backend.params
    chunk_max = engine._chunk_max
    V = cfg.vocab_size
    traffic = engine_traffic(params, cfg, L, device)
    rng, prefix, prompts, news, direct, margins, eos_i, eos = (
        traffic[k] for k in ("rng", "prefix", "prompts", "news", "direct",
                             "margins", "eos_i", "eos"))

    server = ServeServer([backend], host="127.0.0.1", port=0)
    server.start()
    url = f"http://127.0.0.1:{server.port}/v1/generate"
    out = {"model": model, "dtype": str(cfg.dtype).replace("torch.", ""),
           "nvidia_smi": nvidia_smi, "slots": L.slots,
           "max_len": L.max_len, "block_size": L.block_size,
           "pool_blocks": engine.pool.num_blocks,
           "pool_gib": 2 * engine._kp.numel() * engine._kp.element_size()
           / 2 ** 30}
    try:
        status, _ = _http(url, {"tokens": [prefix + prompts[1][:8]],
                                "max_new_tokens": 2})
        require(status == 200, f"engine warm-up status {status}")
        hits0 = ti.SERVE_PREFIX_HITS.value()
        saved0 = ti.SERVE_PREFIX_TOKENS_SAVED.value()
        telemetry.SPAN_RING.clear()
        results = [None] * L.clients

        def client(i):
            payload = {"tokens": [prompts[i]], "max_new_tokens": news[i]}
            if i == eos_i:
                payload["eos_id"] = eos
            results[i] = _http(url, payload)

        with tempfile.TemporaryDirectory() as tmp, \
                StepLogits(engine) as wave_rec:
            path = f"{tmp}/requests.jsonl"
            reqlog.install(path)
            try:
                threads = [threading.Thread(target=client, args=(i,))
                           for i in range(L.clients)]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
                wall = time.perf_counter() - t0
            finally:
                reqlog.uninstall()
            records = {r["request_id"]: r
                       for r in reqlog.read_requests(path)}
        steps = [s["dur"] * 1e3 for s in telemetry.spans()
                 if s["name"] == "serve.decode_step"
                 and s["attrs"].get("active") == L.slots]

        require(not any(t.is_alive() for t in threads), "a client hung")
        toks, gaps, diffs, exact = [], [], [], 0
        for i, (status, body) in enumerate(results):
            require(status == 200, f"request {i}: status {status} {body}")
            got = body["tokens"][0]
            want = direct[i][:5] if i == eos_i else direct[i]
            if i == eos_i:
                require(got[-1] == eos and eos not in got[:-1],
                        f"request {i} did not stop at its EOS: {got}")
            else:
                require(len(got) == news[i],
                        f"request {i}: {len(got)} tokens, asked {news[i]}")
            require(all(0 <= t < V for t in got), f"request {i}: ids")
            gap, diff = check_answer(f"request {i}", params, cfg,
                                     prompts[i], got, wave_rec,
                                     body["request_id"], device)
            gaps.append(gap)
            diffs.append(diff)
            exact += got == want
            toks.append(got)
        recs = [records[body["request_id"]] for _, body in results]
        for i, rec in enumerate(recs):
            if i % 4 == 3:
                want_chunks = -(-len(prompts[i]) // chunk_max)
                require(rec["prefill_chunks"] == want_chunks,
                        f"request {i}: {rec['prefill_chunks']} prefill "
                        f"chunks, expected {want_chunks}")
        hits = ti.SERVE_PREFIX_HITS.value() - hits0
        saved = ti.SERVE_PREFIX_TOKENS_SAVED.value() - saved0
        n_prefixed = (L.clients + 1) // 2
        require(hits >= n_prefixed - 1
                and saved >= (n_prefixed - 1) * L.prefix_len,
                f"prefix cache: {hits} hits, {saved} tokens saved")
        require(len(steps) >= L.min_full_steps,
                f"only {len(steps)} decode steps with {L.slots} lanes")

        status, body = _http(url, {"tokens": [[1] * L.oversize_prompt],
                                   "max_new_tokens": 1})
        require(status == 413 and body.get("reason") == "capacity",
                f"oversize prompt: {status} {body}")
        cancelled = engine.submit(Request(
            prompts[1], max_new_tokens=L.max_len - len(prompts[1]) - 1))
        deadline = time.monotonic() + 300
        while len(cancelled.tokens) < 2:
            require(time.monotonic() < deadline
                    and not cancelled._done.is_set(),
                    "the request to cancel never decoded")
            time.sleep(0.001)
        cancelled.cancel()
        try:
            cancelled.wait(timeout=300)
            require(False, "the cancelled request finished normally")
        except RequestCancelled:
            pass
        while engine.pool.used() and time.monotonic() < deadline:
            time.sleep(0.001)
        require(engine.pool.used() == 0
                and engine.pool.available() == engine.pool.usable_blocks,
                f"pool after the wave: {engine.pool.used()} used, "
                f"{engine.pool.available()} available")
        out["wave"] = {
            "clients": L.clients, "wall_s": wall,
            "generated_tokens": sum(map(len, toks)),
            "tokens_per_s": sum(map(len, toks)) / wall,
            "ttft_s": _percentiles([r["ttft_s"] for r in recs]),
            "tpot_s": _percentiles([r["tpot_s"] for r in recs
                                    if r["tpot_s"] is not None]),
            "decode_step_ms_full": {
                "lanes": L.slots, "steps": len(steps),
                "mean": sum(steps) / len(steps)},
            "prefill_chunks": [r["prefill_chunks"] for r in recs],
            "prefix_hits": hits, "prefix_tokens_saved": saved,
            "eos_request": eos_i, "eos_margin": margins[eos_i],
            "tie_gap_max": max(gaps), "tie_gap_limit": ENGINE_TIE_GAP,
            "logits_diff_max": max(diffs),
            "logits_diff_limit": ENGINE_LOGITS_MAX_ABS,
            "equal_direct_generate": exact,
            "oversize": 413, "cancelled": True}
    finally:
        server.stop()
        engine.stop()

    # the oversubscribed run: every prompt's blocks fill the pool, so the
    # first decode growth preempts the newest request
    over = DecodeEngine(params, cfg, EngineConfig(
        slots=L.slots, max_len=L.max_len, block_size=L.block_size,
        num_blocks=1 + 3 * kvcache.blocks_for(L.max_len, L.block_size)),
        device=device)
    reqs = [over.submit(Request(rng.integers(0, V, L.over_prompt).tolist(),
                                max_new_tokens=L.over_new))
            for _ in range(L.slots)]
    t0 = time.perf_counter()
    with StepLogits(over) as over_rec:
        over.start()
        try:
            outs = [r.wait(timeout=600) for r in reqs]
            wall = time.perf_counter() - t0
        finally:
            over.stop()
    gaps, diffs = zip(*[
        check_answer(f"oversubscribed {i}", params, cfg, r.prompt, toks,
                     over_rec, r.request_id, device)
        for i, (r, toks) in enumerate(zip(reqs, outs))])
    preemptions = sum(r.preemptions for r in reqs)
    require(preemptions >= 1, "the oversubscribed run never preempted")
    require(all(len(r.tokens) == L.over_new for r in reqs),
            "oversubscribed: token counts")
    require(over.pool.used() == 0
            and over.pool.available() == over.pool.usable_blocks,
            "oversubscribed: pool not free after stop")
    out["oversubscribed"] = {
        "requests": L.slots, "prompt": L.over_prompt, "new": L.over_new,
        "pool_blocks": over.pool.num_blocks, "preemptions": preemptions,
        "wall_s": wall, "tie_gap_max": max(gaps),
        "logits_diff_max": max(diffs)}
    # the checks' power: a fault planted in the decode step must be caught
    # by the logits check in every lane
    out["planted"] = [planted_fault(params, cfg, L, prompts, fault, device)
                      for fault in StepLogits.FAULTS]
    for p in out["planted"]:
        require(p["lanes_flagged_by_logits"] == p["lanes"],
                f"the logits check missed a planted fault: {p}")
    out["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                          if on_card else None)
    emit("engine", **out)
    del backend, params, engine, over
    if on_card:
        torch.cuda.empty_cache()
    return out


# -------------------------------------------------------------------- spec --

@dataclasses.dataclass(frozen=True)
class SpecLoad:
    """The spec phase's configuration and traffic: `clients` concurrent
    requests, prompt lengths in turn from `prompt_lens`, `new_tokens`
    each; the last client samples (temperature 0.8), and the greedy
    request with the widest margins stops at an EOS that its first round
    accepts.  `drafts` are the `--spec-model` presets: one that disagrees
    with the target (its own architecture, random weights) and the
    target's own preset, a self-draft (seed 0 both)."""
    slots: int = 8
    max_len: int = 1024
    block_size: int = 16
    k: int = 4
    clients: int = 8
    prompt_lens: tuple = (32, 128, 256, 384)
    new_tokens: int = 32
    drafts: tuple = ("tpu_120m", "tpu_1b")
    fault_new: int = 16


SPEC_LOAD = SpecLoad()
# the CPU rehearsal at `tiny`: a quarter of the lengths; `tiny` is the only
# dense preset of its vocabulary, so both runs are self-drafts there
SPEC_REHEARSAL = SpecLoad(max_len=256, block_size=8,
                          prompt_lens=(8, 32, 64, 96), new_tokens=12,
                          drafts=("tiny", "tiny"), fault_new=8)
# the least acceptance of the self-draft: only bf16 near ties between the
# draft's [1,1] forwards and the [1,k+1] verify reject one of its proposals
SPEC_MIN_SELF_ACCEPTANCE = 0.8


def _collect(on_card: bool) -> None:
    """Free what the last run left: a served backend sits in a reference
    cycle (the server's handler class), so its engine and weights outlive
    the run until the collector finds them."""
    gc.collect()
    if on_card:
        import torch

        torch.cuda.empty_cache()


def spec_round_split(engine, context: int, reps: int = 5) -> dict:
    """Synchronised host ms of a spec round's parts for one slot at
    `context` tokens, on a stopped spec engine's weights and pool: one
    catch-up draft forward, the k-token `draft_propose`, the verify."""
    import torch

    from cloudtik_tpu_torch.models import generate as G

    dev, k = engine.device, engine._spec.k
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    dcfg, dparams = engine._draft_cfg, engine._draft_params
    cache = G.init_cache(dcfg, 1, engine._draft_plane, dev)
    table = torch.arange(1, engine._blocks_per_req + 1, device=dev)
    tok = torch.zeros((), dtype=torch.long, device=dev)
    window = torch.zeros((1, k + 1), dtype=torch.long, device=dev)

    def timed(fn) -> float:
        fn()
        total = 0.0
        for _ in range(reps):
            cache["length"] = context
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            total += time.perf_counter() - t0
        return total / reps * 1e3

    return {"context": context, "k": k,
            "catch_up_forward_ms": timed(lambda: G.forward_step(
                dparams, tok.reshape(1, 1), cache, dcfg)),
            "draft_propose_ms": timed(lambda: G.draft_propose(
                dparams, tok, cache, dcfg, k)),
            "verify_ms": timed(lambda: G.paged_verify(
                engine._params, engine._kp, engine._vp, table, window,
                context, engine.cfg))}


class _Rows:
    """The logits rows of one request from several recorders."""

    def __init__(self, step, verify=None):
        self.step, self.verify = step, verify

    def of(self, req) -> dict:
        rows = dict(self.step.rows(req.request_id))
        if self.verify is not None:
            rows.update(self.verify.rows(req))
        return rows


def check_rows(name, params, cfg, req, rows: dict, device,
               greedy: bool = True) -> tuple:
    """The tie-aware check (greedy answers) and the logits check of one
    finished request over `rows`; returns (largest tie gap or None,
    largest logits difference)."""
    teacher = teacher_logits(params, cfg, req.prompt, req.tokens, device)
    gap = check_tie_aware(name, tie_gaps(params, cfg, req.prompt,
                                         req.tokens, device, teacher)) \
        if greedy else None
    diff = logits_diff(teacher, rows)
    require(diff <= ENGINE_LOGITS_MAX_ABS,
            f"{name}: a step's logits are {diff} from the teacher-forced "
            f"ones (limit {ENGINE_LOGITS_MAX_ABS})")
    return gap, diff


def _serve_wave(engine, url, payloads):
    """POST `payloads` concurrently; returns (wall seconds, the engine's
    Request of each, the ledger record of each)."""
    import tempfile
    import threading

    from cloudtik_tpu_torch.serve import reqlog

    requests = {}
    submit = engine.submit

    def tagged_submit(req):
        requests[len(req.prompt), tuple(req.prompt)] = req
        return submit(req)

    results = [None] * len(payloads)

    def client(i):
        results[i] = _http(url, payloads[i])

    engine.submit = tagged_submit
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/requests.jsonl"
        reqlog.install(path)
        try:
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(payloads))]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
        finally:
            reqlog.uninstall()
            del engine.submit
        # a disaggregated pair also writes each request's "migrated"
        # milestone (the prefill role's half) under the same id
        records = {r["request_id"]: r for r in reqlog.read_requests(path)
                   if r["finish"] != reqlog.FINISH_MIGRATED}
    require(not any(t.is_alive() for t in threads), "a client hung")
    reqs, recs = [], []
    for i, (status, body) in enumerate(results):
        require(status == 200, f"request {i}: status {status} {body}")
        prompt = payloads[i]["tokens"][0]
        req = requests[len(prompt), tuple(prompt)]
        require(body["tokens"][0] == req.tokens, f"request {i}: body")
        reqs.append(req)
        recs.append(records[req.request_id])
    return wall, reqs, recs


def _wave_numbers(wall, reqs, recs, steps_ms=None) -> dict:
    n = sum(len(r.tokens) for r in reqs)
    out = {"wall_s": wall, "generated_tokens": n, "tokens_per_s": n / wall,
           "ttft_s": _percentiles([r["ttft_s"] for r in recs]),
           "tpot_s": _percentiles([r["tpot_s"] for r in recs
                                   if r["tpot_s"] is not None])}
    if steps_ms:
        out["decode_step_ms"] = {"steps": len(steps_ms),
                                 "mean": sum(steps_ms) / len(steps_ms)}
    return out


def phase_spec(model: str = "tpu_1b", device: str = "cuda",
               load: SpecLoad = SPEC_LOAD, nvidia_smi: str = None) -> dict:
    """`tik-serve --engine --spec-model`: `engine_backend(model,
    spec_model=draft, spec_k=k)` behind ServeServer for each of
    `load.drafts`, then a plain `--engine` run of the same requests, then
    a self-draft engine whose verify runs one position on (planted fault).
    Every greedy answer passes the tie-aware check; every verify row at an
    accepted or emitted position, and every plain decode step's row,
    passes the logits check."""
    import numpy as np
    import torch

    from cloudtik_tpu_torch import telemetry
    from cloudtik_tpu_torch.models import generate as G
    from cloudtik_tpu_torch.serve.engine import (
        DecodeEngine, EngineConfig, Request, SpecConfig)
    from cloudtik_tpu_torch.serve.server import ServeServer, engine_backend

    on_card = device == "cuda"
    L = load
    telemetry.enable()
    _collect(on_card)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    out = {"model": model, "nvidia_smi": nvidia_smi, "slots": L.slots,
           "max_len": L.max_len, "block_size": L.block_size, "k": L.k,
           "clients": L.clients, "new_tokens": L.new_tokens, "runs": {}}
    rng = np.random.default_rng(1)
    payloads = eos_i = None
    for run, draft in (("plain", None), ("other_draft", L.drafts[0]),
                       ("self_draft", L.drafts[1])):
        backend = engine_backend(
            model, slots=L.slots, max_len=L.max_len,
            block_size=L.block_size, spec_model=draft, spec_k=L.k,
            device=device)
        engine, cfg, params = backend.engine, backend.cfg, backend.params
        if payloads is None:
            V = cfg.vocab_size
            prompts = [rng.integers(0, V, L.prompt_lens[i % 4]).tolist()
                       for i in range(L.clients)]
            # the EOS request: the greedy one whose first direct tokens
            # lead their runners-up by the most; EOS is its 3rd token, the
            # 2nd proposal of its first round
            margins = []
            for p in prompts[:-1]:
                d = G.generate(params, torch.tensor([p], device=device),
                               cfg, max_new_tokens=4)[0].tolist()
                margins.append((min(greedy_margins(params, cfg, p, d,
                                                   device))
                                if d[2] not in d[:2] else -1.0, d[2]))
            eos_i = int(np.argmax([m for m, _ in margins]))
            payloads = [{"tokens": [p], "max_new_tokens": L.new_tokens}
                        for p in prompts]
            payloads[eos_i]["eos_id"] = margins[eos_i][1]
            payloads[-1]["temperature"] = 0.8
        server = ServeServer([backend], host="127.0.0.1", port=0)
        server.start()
        url = f"http://127.0.0.1:{server.port}/v1/generate"
        try:
            status, _ = _http(url, {"tokens": [[1, 2, 3]],
                                    "max_new_tokens": 2})
            require(status == 200, f"spec warm-up status {status}")
            telemetry.SPAN_RING.clear()
            with StepLogits(engine) as step_rec, \
                    VerifyLogits(engine) as verify_rec:
                wall, reqs, recs = _serve_wave(engine, url, payloads)
        finally:
            server.stop()
            engine.stop()
        require(engine.pool.used() == 0
                and engine.pool.available() == engine.pool.usable_blocks,
                f"{run}: pool not free after stop")
        rows = _Rows(step_rec, verify_rec if draft else None)
        gaps, diffs = [], []
        for i, req in enumerate(reqs):
            greedy = i != L.clients - 1
            gap, diff = check_rows(f"{run} request {i}", params, cfg, req,
                                   rows.of(req), device, greedy)
            diffs.append(diff)
            if greedy:
                gaps.append(gap)
        eos_req = reqs[eos_i]
        require(eos_req.tokens[-1] == payloads[eos_i]["eos_id"]
                and len(eos_req.tokens) == 3,
                f"{run}: the EOS request gave {eos_req.tokens}")
        require(all(len(r.tokens) == L.new_tokens
                    for i, r in enumerate(reqs) if i != eos_i),
                f"{run}: token counts")
        spans = telemetry.spans()
        numbers = _wave_numbers(wall, reqs, recs, [
            s["dur"] * 1e3 for s in spans
            if s["name"] == "serve.decode_step"])
        numbers.update(tie_gap_max=max(gaps), logits_diff_max=max(diffs))
        if draft:
            require(recs[-1]["spec_steps"] == 0,
                    f"{run}: the sampled request speculated")
            greedy_recs = recs[:-1]
            drafted = sum(r["draft_tokens"] for r in greedy_recs)
            accepted = sum(r["accepted_tokens"] for r in greedy_recs)
            verifies = sum(r["spec_steps"] for r in greedy_recs)
            per_req = [r["accepted_tokens"] / r["draft_tokens"]
                       for r in greedy_recs if r["draft_tokens"]]
            rounds = [s["dur"] * 1e3 for s in spans
                      if s["name"] == "serve.spec.verify"]
            require(verifies >= len(greedy_recs) and rounds,
                    f"{run}: {verifies} verify rounds")
            require(sum(len(verify_rec.rows(r)) for r in reqs) > 0,
                    f"{run}: no verify row was recorded")
            numbers.update(
                draft=draft, acceptance=accepted / drafted,
                acceptance_per_request={"min": min(per_req),
                                        "max": max(per_req)},
                tokens_per_verify=(accepted + verifies) / verifies,
                verifies=verifies, spec_round_ms={
                    "rounds": len(rounds),
                    "mean": sum(rounds) / len(rounds)},
                eos_stop_in_first_round=recs[eos_i]["spec_steps"] == 1,
                round_split=spec_round_split(engine, max(L.prompt_lens)
                                             + L.new_tokens // 2))
        out["runs"][run] = numbers
        if run == "self_draft":
            self_params, self_draft = params, engine._draft_params
        del backend, engine, params, server, reqs, step_rec, verify_rec
        _collect(on_card)
    self_run = out["runs"]["self_draft"]
    require(self_run["acceptance"] >= SPEC_MIN_SELF_ACCEPTANCE,
            f"self-draft acceptance {self_run['acceptance']} (limit "
            f"{SPEC_MIN_SELF_ACCEPTANCE})")
    require(self_run["eos_stop_in_first_round"],
            "the self-draft's EOS request did not stop in its first round")

    # the checks' power: a self-draft engine whose verify runs at start+1
    # must be flagged by the logits check in every request
    eng = DecodeEngine(self_params, cfg, EngineConfig(
        slots=L.slots, max_len=L.max_len, block_size=L.block_size,
        spec=SpecConfig(k=L.k)), draft=(self_draft, cfg), device=device)
    reqs = [eng.submit(Request(p["tokens"][0], max_new_tokens=L.fault_new))
            for p in payloads[:L.slots]]
    with StepLogits(eng) as step_rec, \
            VerifyLogits(eng, "shift") as verify_rec:
        eng.start()
        try:
            for r in reqs:
                r.wait(timeout=600)
        finally:
            eng.stop()
    rows = _Rows(step_rec, verify_rec)
    diffs, gaps = [], []
    for r in reqs:
        require(verify_rec.rounds(r) > 0, "planted: a request never "
                "reached the verify")
        teacher = teacher_logits(self_params, cfg, r.prompt, r.tokens,
                                 device)
        diffs.append(logits_diff(teacher, rows.of(r)))
        gaps.append(max(tie_gaps(self_params, cfg, r.prompt, r.tokens,
                                 device, teacher)))
    out["planted"] = {
        "fault": "verify at start + 1", "lanes": len(reqs),
        "logits_diff_per_lane": diffs,
        "logits_diff_min_lane": min(diffs),
        "lanes_flagged_by_logits": sum(d > ENGINE_LOGITS_MAX_ABS
                                       for d in diffs),
        "tie_gap_min_lane": min(gaps),
        "lanes_flagged_by_tie_gap": sum(g > ENGINE_TIE_GAP for g in gaps)}
    require(out["planted"]["lanes_flagged_by_logits"] == len(reqs),
            f"the logits check missed the planted verify fault: "
            f"{out['planted']}")
    out["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                          if on_card else None)
    emit("spec", **out)
    del eng, reqs, self_params, self_draft
    _collect(on_card)
    return out


# -------------------------------------------------------------------- lora --

@dataclasses.dataclass(frozen=True)
class LoraLoad:
    """The lora phase's configuration and traffic.  `adapters` adapters of
    rank `rank` (alpha `alpha`, targets wq and wv) from the port's
    `random_lora_params`, `capacity` plane slots.  The mixed run: request
    i asks for adapter MIXED[i] (None: the base model) with a prompt of
    prompt_lens[i % 4] tokens; then `homogeneous` requests on one
    adapter.  `draft` is the preset of the per-adapter draft.  `b_scale`
    is `random_lora_params`' spread of b (the reference's 0.05)."""
    slots: int = 8
    max_len: int = 1024
    block_size: int = 16
    rank: int = 16
    alpha: float = 32.0
    b_scale: float = 0.05
    adapters: int = 4
    capacity: int = 3
    prompt_lens: tuple = (32, 128, 256, 384)
    new_tokens: int = 24
    homogeneous: int = 4
    draft: str = "tpu_120m"
    k: int = 4


LORA_LOAD = LoraLoad()
# the CPU rehearsal at `tiny`: its 2 layers compound an adapter's delta
# less than tpu_1b's 16, so its adapters draw b twice as wide
LORA_REHEARSAL = LoraLoad(max_len=256, block_size=8,
                          prompt_lens=(8, 32, 64, 96), new_tokens=8,
                          draft="tiny", b_scale=0.1)
# 12 requests: 3 on the base model, 9 over the 4 adapters.  The first 8
# fill the slots on 3 adapters; a3 then waits until one of them idles, and
# evicts it
MIXED = (None, "a0", "a1", "a2", None, "a0", "a1", "a2", "a3", "a3", None,
         "a3")
# the adapters must move the teacher's logits well past the logits check's
# limit, or the check could not tell a lane on the wrong adapter
LORA_MIN_ADAPTER_EFFECT = 4 * ENGINE_LOGITS_MAX_ABS


def phase_lora(model: str = "tpu_1b", device: str = "cuda",
               load: LoraLoad = LORA_LOAD, nvidia_smi: str = None) -> dict:
    """Multi-tenant LoRA on `DecodeEngine(adapters=AdapterPool(...))`:
    a mixed run of 12 concurrent greedy requests over 4 adapters and the
    base model with 3 plane slots (gathered steps, evictions, a wait on a
    pinned slot), a homogeneous run (merged steps), tenant isolation of
    the prefix cache, an unknown adapter, a spec engine with one
    per-adapter draft, and a planted fault (adapter indices rolled one
    lane on).  Every answer passes the tie-aware check and every decode
    step's logits the logits check against a teacher-forced forward over
    `merge_lora(base, adapter)`."""
    import numpy as np
    import torch

    from cloudtik_tpu_torch import telemetry
    from cloudtik_tpu_torch.models import generate as G
    from cloudtik_tpu_torch.models import lora as LO
    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.serve.adapters import (
        AdapterLoadError, AdapterPool, AdapterSlotsExhausted)
    from cloudtik_tpu_torch.serve.engine import (
        DecodeEngine, EngineConfig, Request, SpecConfig)
    from cloudtik_tpu_torch.telemetry import instruments as ti

    on_card = device == "cuda"
    L = load
    telemetry.enable()
    _collect(on_card)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    cfg = T.config(model)
    params = T.init_params(torch.Generator(device=device).manual_seed(0),
                           cfg, device)
    lora_cfg = LO.LoRAConfig(rank=L.rank, alpha=L.alpha)
    bank = {f"a{i}": LO.random_lora_params(
        torch.Generator(device=device).manual_seed(i + 1), cfg, lora_cfg,
        scale=L.b_scale, device=device) for i in range(L.adapters)}
    merged = {None: params}
    merged.update({a: dict(params, layers=LO.merge_lora(
        params["layers"], ad, lora_cfg)) for a, ad in bank.items()})
    waits = []

    def make_pool():
        pool = AdapterPool(params, cfg, lora_cfg, loader=bank.__getitem__,
                           capacity=L.capacity)
        acquire = pool.acquire

        def counted_acquire(adapter_id):
            try:
                return acquire(adapter_id)
            except AdapterSlotsExhausted:
                waits.append(adapter_id)
                raise

        pool.acquire = counted_acquire
        return pool

    def make_engine(spec=None, **kw):
        _collect(on_card)    # the last section's engine and pool
        return DecodeEngine(params, cfg, EngineConfig(
            slots=L.slots, max_len=L.max_len, block_size=L.block_size,
            spec=spec), adapters=make_pool(), device=device, **kw)

    def run(eng, specs, fault=None, verify=False):
        reqs = [eng.submit(Request(p, max_new_tokens=L.new_tokens,
                                   adapter_id=a, tenant=a or "base"))
                for p, a in specs]
        t0 = time.perf_counter()
        with StepLogits(eng, fault) as step_rec:
            if verify:
                with VerifyLogits(eng) as verify_rec:
                    eng.start()
                    for r in reqs:
                        r.wait(timeout=600)
            else:
                verify_rec = None
                eng.start()
                for r in reqs:
                    r.wait(timeout=600)
        wall = time.perf_counter() - t0
        return reqs, _Rows(step_rec, verify_rec), step_rec, wall

    def check(name, reqs, rows):
        gaps, diffs = zip(*[check_rows(
            f"{name} {i}", merged[r.adapter_id], cfg, r, rows.of(r), device)
            for i, r in enumerate(reqs)])
        return max(gaps), max(diffs)

    def steps_by_lanes() -> dict:
        """Decode-step ms since the span ring was cleared, by lanes."""
        by_lanes = {}
        for s in telemetry.spans():
            if s["name"] == "serve.decode_step":
                by_lanes.setdefault(s["attrs"]["active"], []).append(
                    s["dur"] * 1e3)
        return {n: {"steps": len(v), "mean": sum(v) / len(v)}
                for n, v in sorted(by_lanes.items())}

    def pool_free(eng, name):
        require(eng.pool.used() == 0
                and eng.pool.available() == eng.pool.usable_blocks
                and not eng._adapters._ref,
                f"{name}: KV or adapter pool not free after stop")

    rng = np.random.default_rng(2)
    V = cfg.vocab_size
    prompts = [rng.integers(0, V, L.prompt_lens[i % 4]).tolist()
               for i in range(len(MIXED))]
    out = {"model": model, "nvidia_smi": nvidia_smi, "slots": L.slots,
           "max_len": L.max_len, "rank": L.rank, "alpha": L.alpha,
           "targets": list(lora_cfg.targets), "adapters": L.adapters,
           "capacity": L.capacity, "new_tokens": L.new_tokens}

    # the adapters must matter: the teacher's logits of each adapter
    # against the base model's, over one prompt and the base's answer
    base_answer = G.generate(params, torch.tensor([prompts[1]],
                                                  device=device), cfg,
                             max_new_tokens=L.new_tokens)[0].tolist()
    base_teacher = teacher_logits(params, cfg, prompts[1], base_answer,
                                  device)
    effect = {a: float((teacher_logits(merged[a], cfg, prompts[1],
                                       base_answer, device)
                        - base_teacher).abs().max())
              for a in bank}
    out["adapter_effect"] = effect
    require(min(effect.values()) >= LORA_MIN_ADAPTER_EFFECT,
            f"an adapter moves the teacher's logits by only "
            f"{min(effect.values())} (limit {LORA_MIN_ADAPTER_EFFECT})")

    # the mixed run: gathered steps, evictions and a wait on a pinned slot
    eng = make_engine()
    evictions0 = ti.SERVE_ADAPTER_EVICTIONS.value()
    telemetry.SPAN_RING.clear()
    reqs, rows, _, wall = run(eng, list(zip(prompts, MIXED)))
    eng.stop()
    steps = steps_by_lanes()
    gap, diff = check("mixed", reqs, rows)
    require(eng._gathered_steps >= 1, "the mixed run never gathered")
    require(waits, "the mixed run never waited on a pinned adapter slot")
    evictions = ti.SERVE_ADAPTER_EVICTIONS.value() - evictions0
    require(evictions >= 1, "the mixed run never evicted an adapter")
    pool_free(eng, "mixed")
    n = sum(len(r.tokens) for r in reqs)
    out["mixed"] = {
        "requests": len(reqs), "wall_s": wall, "generated_tokens": n,
        "tokens_per_s": n / wall,
        "gathered_steps": eng._gathered_steps,
        "merged_steps": eng._merged_steps, "evictions": evictions,
        "slot_waits": len(waits),
        "decode_step_ms_by_lanes": steps,
        "tie_gap_max": gap, "logits_diff_max": diff}

    # the homogeneous run: every lane on one adapter -> merged steps
    del eng, reqs, rows
    eng = make_engine()
    telemetry.SPAN_RING.clear()
    reqs, rows, _, wall = run(eng, [(p, "a1") for p in
                                    prompts[:L.homogeneous]])
    eng.stop()
    steps = steps_by_lanes()
    gap, diff = check("homogeneous", reqs, rows)
    require(eng._merged_steps >= 1 and eng._gathered_steps == 0,
            f"homogeneous run: {eng._merged_steps} merged, "
            f"{eng._gathered_steps} gathered steps")
    pool_free(eng, "homogeneous")
    out["homogeneous"] = {"requests": len(reqs), "wall_s": wall,
                          "merged_steps": eng._merged_steps,
                          "decode_step_ms_by_lanes": steps,
                          "tie_gap_max": gap, "logits_diff_max": diff}

    # tenant isolation of the prefix cache, and an unknown adapter
    del eng, reqs, rows
    eng = make_engine()
    eng.start()
    shared = prompts[3][:4 * L.block_size + 1]
    try:
        iso = []
        for a in ("a0", "a1", "a0"):
            r = eng.submit(Request(shared, max_new_tokens=2, adapter_id=a))
            r.wait(timeout=600)
            iso.append(r)
        bad = eng.submit(Request(prompts[0], max_new_tokens=2,
                                 adapter_id="no-such-adapter"))
        good = eng.submit(Request(prompts[0], max_new_tokens=2,
                                  adapter_id="a2"))
        try:
            bad.wait(timeout=600)
            require(False, "the unknown adapter's request was served")
        except AdapterLoadError:
            pass
        good.wait(timeout=600)
    finally:
        eng.stop()
    require(iso[1].prefix_tokens == 0 and iso[2].prefix_tokens > 0,
            f"prefix isolation: {[r.prefix_tokens for r in iso]}")
    pool_free(eng, "isolation")
    out["isolation"] = {"prefix_tokens": [r.prefix_tokens for r in iso],
                        "unknown_adapter_failed_alone": True}

    # spec with a per-adapter draft: a0 speculates, a1 decodes plain
    del eng, iso, bad, good
    dcfg = T.config(L.draft)
    dparams = T.init_params(torch.Generator(device=device).manual_seed(1),
                            dcfg, device)
    eng = make_engine(SpecConfig(k=L.k), draft=(dparams, dcfg),
                      adapter_drafts={"a0": dparams})
    reqs, rows, _, _ = run(eng, [(prompts[2], "a0"), (prompts[3], "a1")],
                           verify=True)
    eng.stop()
    gap, diff = check("adapter draft", reqs, rows)
    require(reqs[0].spec_steps > 0 and reqs[1].spec_steps == 0,
            f"adapter drafts: spec steps {reqs[0].spec_steps}, "
            f"{reqs[1].spec_steps}")
    pool_free(eng, "adapter draft")
    out["adapter_draft"] = {
        "draft": L.draft, "spec_steps": [r.spec_steps for r in reqs],
        "accepted": reqs[0].accepted_tokens,
        "drafted": reqs[0].draft_tokens,
        "tie_gap_max": gap, "logits_diff_max": diff}
    del dparams, eng, reqs, rows

    # the checks' power: adapter indices rolled one lane on in the
    # gathered step; every request whose adapter that changed is flagged
    eng = make_engine()
    specs = [(p, a) for p, a in zip(prompts, (None, "a0", "a1", "a2") * 2)]
    reqs, rows, step_rec, _ = run(eng, specs, fault="adapters")
    eng.stop()
    diffs = {r.request_id: logits_diff(teacher_logits(
        merged[r.adapter_id], cfg, r.prompt, r.tokens, device),
        rows.of(r)) for r in reqs}
    moved = [r.request_id for r in reqs if step_rec.changed(r.request_id)]
    out["planted"] = {
        "fault": "adapter indices rolled", "lanes": len(reqs),
        "lanes_changed": len(moved),
        "logits_diff_per_lane": list(diffs.values()),
        "lanes_flagged_by_logits": sum(diffs[i] > ENGINE_LOGITS_MAX_ABS
                                       for i in moved),
        "logits_diff_min_changed_lane": min(diffs[i] for i in moved)
        if moved else None}
    require(moved and out["planted"]["lanes_flagged_by_logits"]
            == len(moved),
            f"the logits check missed the planted adapter fault: "
            f"{out['planted']}")
    out["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                          if on_card else None)
    emit("lora", **out)
    del eng, reqs, rows, step_rec, params, merged, bank
    _collect(on_card)
    return out


# ------------------------------------------------------------------ disagg --

class MigrationLog:
    """Times each migration of a prefill-role engine into a decode-role
    engine while entered, and keeps the bits of one: per migration the
    gather + device-to-host ms (`_migrate_out` less its export), the
    pack + send ms (the migrator's export: over the loopback that includes
    the inbox's reassembly), and the import ms (the decode loop's
    host-to-device copy and scatter, ended by a synchronise the log adds).
    The first migration of a prompt of at least `keep_len` tokens has its
    prefill-pool blocks cloned before the export and its decode-pool
    blocks cloned after the import."""

    def __init__(self, prefill, decode, keep_len: int):
        self.prefill, self.decode, self.keep_len = prefill, decode, keep_len
        self.out, self.imports, self.kept = [], [], {}

    def __enter__(self):
        import torch

        pre, dec = self.prefill, self.decode
        sync = torch.cuda.synchronize if dec.device.type == "cuda" \
            else (lambda: None)
        migrate_out, export = pre._migrate_out, pre._migrator.export
        scatter, stamp = dec._scatter_imported, dec._stamp_first_token
        current = {}

        def timed_migrate_out(slot_id, slot, first_tok):
            req = slot.request
            if slot.true_len >= self.keep_len and not self.kept:
                table = slot.table[:-(-slot.true_len // pre.ec.block_size)]
                self.kept[req.request_id] = {"prefill": (
                    pre._kp[:, table].clone(), pre._vp[:, table].clone())}
            current.clear()
            t0 = time.perf_counter()
            migrate_out(slot_id, slot, first_tok)
            total = (time.perf_counter() - t0) * 1e3
            if "export_ms" in current:
                self.out.append({
                    "request": req.request_id, "tokens": slot.true_len,
                    "mb": current["mb"],
                    "gather_d2h_ms": total - current["export_ms"],
                    "pack_send_ms": current["export_ms"]})

        def timed_export(request, **kw):
            t0 = time.perf_counter()
            export(request, **kw)
            current["export_ms"] = (time.perf_counter() - t0) * 1e3
            current["mb"] = 2 * kw["k"].numel() * kw["k"].element_size() \
                / 1e6

        def timed_scatter(table, start, k, v):
            t0 = time.perf_counter()
            scatter(table, start, k, v)
            sync()
            self.imports.append({
                "blocks": len(table) - start, "reused": start,
                "mb": 2 * k[:, start:].numel() * k.element_size() / 1e6,
                "import_ms": (time.perf_counter() - t0) * 1e3})

        def import_stamp(slot_id, slot, first_tok):
            # an import stamps its first token right after its scatter
            rid = slot.request.request_id
            if slot.request.migrations:
                self.imports[-1]["request"] = rid
                kept = self.kept.get(rid)
                if kept is not None and "decode" not in kept:
                    kept["decode"] = (dec._kp[:, slot.table].clone(),
                                      dec._vp[:, slot.table].clone())
            return stamp(slot_id, slot, first_tok)

        pre._migrate_out, pre._migrator.export = timed_migrate_out, \
            timed_export
        dec._scatter_imported, dec._stamp_first_token = timed_scatter, \
            import_stamp
        return self

    def __exit__(self, *exc):
        del self.prefill._migrate_out, self.decode._scatter_imported
        del self.decode._stamp_first_token, self.prefill._migrator.export

    def bit_equal_blocks(self) -> int:
        """How many blocks the kept request migrated, when its decode-pool
        blocks equal its prefill-pool blocks bit for bit (K and V); else
        0."""
        import torch

        for kept in self.kept.values():
            if "decode" in kept and all(
                    torch.equal(a, b) for a, b in zip(kept["prefill"],
                                                      kept["decode"])):
                return kept["decode"][0].shape[1]
        return 0

    def summary(self) -> dict:
        """Per migration its three stages, MB and GB/s over the three;
        per stage the totals and rate; and the largest migration's row."""
        imports = {r["request"]: r for r in self.imports}
        rows = []
        for r in self.out:
            imp = imports[r["request"]]
            ms = r["gather_d2h_ms"] + r["pack_send_ms"] + imp["import_ms"]
            rows.append(dict(r, import_ms=imp["import_ms"],
                             import_mb=imp["mb"], reused=imp["reused"],
                             gb_per_s=r["mb"] / ms))
        out = {"migrations": len(self.out), "imports": len(self.imports),
               "rows": rows}
        for stage, src in (("gather_d2h", self.out),
                           ("pack_send", self.out),
                           ("import", self.imports)):
            ms = sum(r[f"{stage}_ms"] for r in src)
            mb = sum(r["mb"] for r in src)
            out[stage] = {"ms_total": ms, "mb_total": mb,
                          "gb_per_s": mb / ms if ms else None}
        if rows:
            out["largest"] = max(rows, key=lambda r: r["mb"])
        return out


def planted_import_shift(params, cfg, load, rng, device) -> dict:
    """The logits check's power on the migration path: `load.slots`
    requests through a disaggregated pair whose decode role lands each
    request's imported planes one block on (block j's planes in table
    entry j + 1: the first entry keeps what the pool held there, the last
    block's planes are dropped), its prefix cache off so that every block
    is imported.  Attention over the prompt is blind to which block holds
    which (already rotated) positions, so what the shift changes is the
    first and the last block: the prompts, drawn from `rng`, are two
    blocks less three tokens each, so that it changes half of each one.
    Every import moves; returns how many of those lanes the logits check
    flags."""
    from cloudtik_tpu_torch.serve.disagg import DisaggServing
    from cloudtik_tpu_torch.serve.engine import EngineConfig, Request

    ec = dict(max_len=load.max_len, block_size=load.block_size)
    pair = DisaggServing(params, cfg, EngineConfig(slots=2, **ec),
                         EngineConfig(slots=load.slots, prefix_cache=False,
                                      **ec), device=device)
    scatter = pair.decode._scatter_imported
    stamp = pair.decode._stamp_first_token
    moved, changed = [], set()

    def shifted(table, start, k, v):
        moved.append(len(table) > start)
        scatter(table[start + 1:], 0, k[:, start:-1], v[:, start:-1])

    def tagged_stamp(slot_id, slot, first_tok):
        # an import stamps its first token right after its scatter
        if slot.request.migrations and moved.pop():
            changed.add(slot.request.request_id)
        return stamp(slot_id, slot, first_tok)

    pair.decode._scatter_imported = shifted
    pair.decode._stamp_first_token = tagged_stamp
    reqs = [Request(rng.integers(0, cfg.vocab_size,
                                 2 * load.block_size - 3).tolist(),
                    max_new_tokens=load.short_new)
            for _ in range(load.slots)]
    with StepLogits(pair.decode) as rec:
        pair.start()
        try:
            for r in reqs:
                pair.submit(r)
            outs = [r.wait(timeout=600) for r in reqs]
        finally:
            pair.stop()
    diffs = {r.request_id: logits_diff(teacher_logits(
        params, cfg, r.prompt, toks, device), rec.rows(r.request_id))
        for r, toks in zip(reqs, outs)}
    return {"fault": "imported planes one block on",
            "lanes": len(reqs), "lanes_changed": len(changed),
            "logits_diff_per_lane": list(diffs.values()),
            "lanes_flagged_by_logits": sum(diffs[i] > ENGINE_LOGITS_MAX_ABS
                                           for i in changed),
            "logits_diff_min_changed_lane": min(
                (diffs[i] for i in changed), default=None)}


def phase_disagg(model: str = "tpu_1b", device: str = "cuda",
                 load: EngineLoad = ENGINE_LOAD, prefill_slots: int = 2,
                 nvidia_smi: str = None) -> dict:
    """`tik-serve --engine --disagg`: `engine_backend(model, disagg=True,
    prefill_slots=2)` at the engine phase's configuration behind
    ServeServer, the engine phase's traffic (16 clients, a shared cached
    prefix, one EOS).  Every answer passes the tie-aware check and every
    decode-role step the logits check; every record carries one migration
    of its whole prompt; both roles hit their prefix caches; one migrated
    request's blocks arrive bit for bit; both pools end free.  Then two
    requests torn by a planted `serve.kvcache.migrate` fault must answer
    right through the fallback, and a pair whose import lands its blocks
    one position on must be flagged in every lane it changes.  The same
    requests through a monolithic `--engine` backend, for the numbers."""
    import torch

    from cloudtik_tpu_torch import telemetry
    from cloudtik_tpu_torch.faults import seams
    from cloudtik_tpu_torch.faults.plan import FaultPlan, FaultPoint
    from cloudtik_tpu_torch.serve.engine import Request
    from cloudtik_tpu_torch.serve.server import ServeServer, engine_backend
    from cloudtik_tpu_torch.telemetry import instruments as ti

    on_card = device == "cuda"
    L = load
    telemetry.enable()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    backend = engine_backend(model, slots=L.slots, max_len=L.max_len,
                             block_size=L.block_size, disagg=True,
                             prefill_slots=prefill_slots, device=device)
    pair, cfg, params = backend.engine, backend.cfg, backend.params
    V = cfg.vocab_size
    traffic = engine_traffic(params, cfg, L, device, direct_new=5)
    rng, prefix, prompts, news, eos_i, eos = (
        traffic[k] for k in ("rng", "prefix", "prompts", "news", "eos_i",
                             "eos"))
    payloads = [{"tokens": [p], "max_new_tokens": n}
                for p, n in zip(prompts, news)]
    payloads[eos_i]["eos_id"] = eos
    warm = {"tokens": [prefix + prompts[1][:8]], "max_new_tokens": 2}
    out = {"model": model, "dtype": str(cfg.dtype).replace("torch.", ""),
           "nvidia_smi": nvidia_smi, "decode_slots": L.slots,
           "prefill_slots": prefill_slots, "max_len": L.max_len,
           "block_size": L.block_size,
           "pool_blocks": {"prefill": pair.prefill.pool.num_blocks,
                           "decode": pair.decode.pool.num_blocks}}

    server = ServeServer([backend], host="127.0.0.1", port=0)
    server.start()
    url = f"http://127.0.0.1:{server.port}/v1/generate"
    try:
        status, _ = _http(url, warm)
        require(status == 200, f"disagg warm-up status {status}")
        failures0 = ti.SERVE_KV_MIGRATION_FAILURES.value()
        with StepLogits(pair.decode) as rec, \
                MigrationLog(pair.prefill, pair.decode,
                             max(map(len, prompts))) as mig:
            wall, reqs, recs = _serve_wave(pair, url, payloads)
            # two requests torn by a planted fault: at the second block
            # of the first, then at the first block of the second
            torn = [Request(rng.integers(0, V, 8 * L.block_size).tolist(),
                            max_new_tokens=L.short_new) for _ in range(2)]
            plan = FaultPlan([FaultPoint("serve.kvcache.migrate", "raise",
                                         at_call=2, times=2)])
            with seams.armed(plan):
                for r in torn:
                    pair.submit(r)
                for r in torn:
                    r.wait(timeout=600)
        gaps, diffs = [], []
        for i, req in enumerate(reqs):
            got = req.tokens
            if i == eos_i:
                require(got[-1] == eos and eos not in got[:-1],
                        f"request {i} did not stop at its EOS: {got}")
            else:
                require(len(got) == news[i],
                        f"request {i}: {len(got)} tokens, asked {news[i]}")
            require(all(0 <= t < V for t in got), f"request {i}: ids")
            gap, diff = check_answer(f"disagg request {i}", params, cfg,
                                     req.prompt, got, rec, req.request_id,
                                     device)
            gaps.append(gap)
            diffs.append(diff)
            require(recs[i]["migrations"] == 1
                    and recs[i]["migrated_tokens"] == len(req.prompt),
                    f"request {i}: migrations {recs[i]['migrations']}, "
                    f"migrated_tokens {recs[i]['migrated_tokens']} of "
                    f"{len(req.prompt)}")
        require(plan.points[0].fired == 2,
                f"the planted tear fired {plan.points[0].fired} times")
        torn_checks = [check_answer(f"torn request {j}", params, cfg,
                                    r.prompt, r.tokens, rec, r.request_id,
                                    device) for j, r in enumerate(torn)]
        require(all(r.error is None and r.migrations == 0
                    and len(r.tokens) == L.short_new for r in torn),
                "a torn request did not finish through the fallback")
        failures = ti.SERVE_KV_MIGRATION_FAILURES.value() - failures0
        require(failures == 2, f"migration failures counted: {failures}")
        prefill_hits = sum(r["prefix_tokens"] > 0 for r in recs)
        decode_hits = sum(r["reused"] > 0 for r in mig.imports)
        require(prefill_hits >= 1 and decode_hits >= 1,
                f"prefix hits: prefill role {prefill_hits}, decode role "
                f"{decode_hits}")
        bit_equal = mig.bit_equal_blocks()
        require(bit_equal > 0,
                "a migrated request's decode-pool blocks differ from its "
                "prefill-pool blocks")
        out["wave"] = dict(
            _wave_numbers(wall, reqs, recs), clients=L.clients,
            tie_gap_max=max(gaps), tie_gap_limit=ENGINE_TIE_GAP,
            logits_diff_max=max(diffs),
            logits_diff_limit=ENGINE_LOGITS_MAX_ABS,
            migrated_tokens=[r["migrated_tokens"] for r in recs],
            prefix_hits={"prefill": prefill_hits, "decode": decode_hits},
            bit_equal_blocks=bit_equal)
        out["migration"] = mig.summary()
        out["torn"] = {"requests": len(torn), "fired": 2,
                       "failures_counted": failures,
                       "tie_gap_max": max(g for g, _ in torn_checks),
                       "logits_diff_max": max(d for _, d in torn_checks)}
    finally:
        server.stop()
        pair.stop()
    require(pair.prefill.pool.used() == 0 and pair.decode.pool.used() == 0,
            f"pools after stop: prefill {pair.prefill.pool.used()}, "
            f"decode {pair.decode.pool.used()} used")
    out["planted"] = planted_import_shift(params, cfg, L, rng, device)
    p = out["planted"]
    require(p["lanes_changed"] == p["lanes"]
            and p["lanes_flagged_by_logits"] == p["lanes_changed"],
            f"the logits check missed the planted import shift: {p}")

    # the same requests through a monolithic `--engine` backend
    mono = engine_backend(model, slots=L.slots, max_len=L.max_len,
                          block_size=L.block_size, device=device)
    server = ServeServer([mono], host="127.0.0.1", port=0)
    server.start()
    url = f"http://127.0.0.1:{server.port}/v1/generate"
    try:
        status, _ = _http(url, warm)
        require(status == 200, f"monolith warm-up status {status}")
        wall, reqs, recs = _serve_wave(mono.engine, url, payloads)
        gaps = [check_tie_aware(f"monolith request {i}", tie_gaps(
            params, cfg, r.prompt, r.tokens, device))
            for i, r in enumerate(reqs)]
        out["monolith"] = dict(_wave_numbers(wall, reqs, recs),
                               tie_gap_max=max(gaps))
    finally:
        server.stop()
        mono.engine.stop()
    out["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                          if on_card else None)
    out["seconds"] = time.perf_counter() - t_phase
    emit("disagg", **out)
    del backend, pair, params, mono
    _collect(on_card)
    return out


# ------------------------------------------------------------------ fabric --

@dataclasses.dataclass(frozen=True)
class FabricLoad:
    """The fabric phase's configuration and traffic: one prefill replica
    (`prefill_slots` lanes) and two decode replicas (`decode_slots` lanes
    each), blocks of `block_size`; prompts of `heavy_lens` tokens (at or
    over `threshold`: the fabric hop) and `short_lens` (direct), taken in
    turn, `new_tokens` each; `kill_requests` heavy requests in flight
    when the prefill replica is killed."""
    max_len: int = 1024
    block_size: int = 16
    prefill_slots: int = 2
    decode_slots: int = 4
    threshold: int = 64
    heavy_lens: tuple = (384, 700)
    short_lens: tuple = (16, 48)
    clients: int = 8
    new_tokens: int = 24
    kill_requests: int = 4


FABRIC_LOAD = FabricLoad()
# the CPU rehearsal at `tiny`: the same traffic at a quarter of the lengths
FABRIC_REHEARSAL = FabricLoad(max_len=256, block_size=8, threshold=16,
                              heavy_lens=(96, 175), short_lens=(4, 12),
                              new_tokens=8)


class HandoffLog:
    """Times each socket export of a `FabricMigrator` while entered: per
    handoff the ms from opening the transport to the commit frame sent,
    and the planes' MB."""

    def __init__(self, migrator):
        self.migrator, self.rows = migrator, []

    def __enter__(self):
        send = self.migrator._send

        def timed_send(request, handoff, kw):
            t0 = time.perf_counter()
            send(request, handoff, kw)
            self.rows.append({
                "tokens": kw["length"],
                "mb": 2 * kw["k"].numel() * kw["k"].element_size() / 1e6,
                "handoff_ms": (time.perf_counter() - t0) * 1e3})

        self.migrator._send = timed_send
        return self

    def __exit__(self, *exc):
        del self.migrator._send

    def summary(self) -> dict:
        ms = sum(r["handoff_ms"] for r in self.rows)
        mb = sum(r["mb"] for r in self.rows)
        return {"handoffs": len(self.rows), "rows": self.rows,
                "handoff_ms": _percentiles([r["handoff_ms"]
                                            for r in self.rows]),
                "wire_gb_per_s": mb / ms if ms else None}


def phase_fabric(model: str = "tpu_1b", device: str = "cuda",
                 load: FabricLoad = FABRIC_LOAD,
                 nvidia_smi: str = None) -> dict:
    """The serving fabric on the card: a `PrefillReplica` and two
    `DecodeReplica`s, each its own engine over one set of weights, behind
    the prefix-affinity `Router` with a `ReplicaRegistry` over
    `InMemoryStateBackend`; KV blocks cross `SocketKVTransport` on
    127.0.0.1.  Prompt-heavy requests must take the fabric hop and short
    ones go direct; a torn migration falls back on the decode replica the
    router chose; a prefill replica killed mid-traffic leaves every greedy
    request answered.  Every answer passes the tie-aware check (outcomes,
    never timings)."""
    import numpy as np
    import torch

    from cloudtik_tpu_torch import telemetry
    from cloudtik_tpu_torch.control.state import (
        InMemoryStateBackend, StateClient)
    from cloudtik_tpu_torch.faults import seams
    from cloudtik_tpu_torch.faults.plan import FaultPlan, FaultPoint
    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.serve import fabric
    from cloudtik_tpu_torch.serve.engine import (
        DecodeEngine, EngineConfig, Request)
    from cloudtik_tpu_torch.serve.replicas import ReplicaRegistry
    from cloudtik_tpu_torch.serve.router import (
        Router, RouterConfig, chain_hash)
    from cloudtik_tpu_torch.telemetry import instruments as ti

    on_card = device == "cuda"
    L = load
    telemetry.enable()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    cfg = T.config(model)
    params = T.init_params(torch.Generator(device=device).manual_seed(0),
                           cfg, device)
    ec = dict(max_len=L.max_len, block_size=L.block_size)
    prefill = fabric.PrefillReplica("p0", DecodeEngine(
        params, cfg, EngineConfig(slots=L.prefill_slots, **ec),
        migrator=fabric.FabricMigrator(), device=device))
    decodes = [fabric.DecodeReplica(f"d{i}", DecodeEngine(
        params, cfg, EngineConfig(slots=L.decode_slots, **ec),
        role="decode", device=device)) for i in range(2)]
    replicas = [prefill] + decodes
    for r in replicas:
        r.engine.start()
    router = Router(ReplicaRegistry(StateClient(InMemoryStateBackend())),
                    RouterConfig(block_size=L.block_size,
                                 prefill_len_threshold=L.threshold,
                                 request_deadline_s=600))
    router.add_client(prefill, role="prefill", slots=L.prefill_slots)
    for r in decodes:
        router.add_client(r, role="decode", slots=L.decode_slots)
    rng = np.random.default_rng(1)
    V = cfg.vocab_size

    def prompt(n):
        return rng.integers(0, V, n).tolist()

    def paths():
        return {p: ti.SERVE_FABRIC_REQUESTS.value(path=p)
                for p in ("migrated", "fallback", "direct")}

    def answered(name, answers):
        """The largest tie gap over (prompt, tokens, error) answers, each
        complete and right."""
        gaps = []
        for j, (p, toks, error) in enumerate(answers):
            require(error is None and len(toks) == L.new_tokens,
                    f"{name} {j}: error {error!r}, {len(toks)} tokens of "
                    f"{L.new_tokens}")
            gaps.append(check_tie_aware(f"{name} {j}", tie_gaps(
                params, cfg, p, toks, device)))
        return max(gaps)

    def done(reqs):
        return [(r.prompt, r.tokens, r.error) for r in reqs]

    out = {"model": model, "dtype": str(cfg.dtype).replace("torch.", ""),
           "nvidia_smi": nvidia_smi, **dataclasses.asdict(L)}
    try:
        for n in (L.heavy_lens[0], L.short_lens[0]):
            router.handle({"tokens": prompt(n), "max_new_tokens": 2})
        # the wave: heavy and short requests in turn, all at once
        lens = [(L.heavy_lens, L.short_lens)[i % 2][i // 2 % 2]
                for i in range(L.clients)]
        reqs = [Request(prompt(n), max_new_tokens=L.new_tokens)
                for n in lens]
        before = paths()
        with HandoffLog(prefill.engine._migrator) as handoffs:
            t0 = time.perf_counter()
            for r in reqs:
                router.submit(r)
            for r in reqs:
                r.wait(timeout=600)
            wall = time.perf_counter() - t0
        after = paths()
        n_heavy = sum(n >= L.threshold for n in lens)
        require(after == dict(before, migrated=before["migrated"]
                              + n_heavy),
                f"fabric paths moved {before} -> {after}, expected "
                f"{n_heavy} migrated and nothing else")
        out["wave"] = {"requests": len(reqs), "heavy": n_heavy,
                       "wall_s": wall,
                       "tokens_per_s": sum(len(r.tokens) for r in reqs)
                       / wall,
                       "tie_gap_max": answered("fabric request",
                                               done(reqs)),
                       **handoffs.summary()}

        # a torn migration: the fallback re-prefills on the decode
        # replica the router chose
        torn = prompt(L.heavy_lens[0])
        chosen = router._pick(chain_hash(torn, L.block_size), set())[0]
        fell_back = []
        for r in decodes:
            take = r.take_fallback
            r.take_fallback = (lambda ticket, req, r=r, take=take: (
                fell_back.append(r.replica_id), take(ticket, req))[1])
        failures0 = ti.SERVE_KV_MIGRATION_FAILURES.value()
        before = paths()
        plan = FaultPlan([FaultPoint("serve.kvcache.migrate", "raise",
                                     at_call=2, times=1)])
        try:
            with seams.armed(plan):
                res = router.handle({"tokens": torn,
                                     "max_new_tokens": L.new_tokens})
        finally:
            for r in decodes:
                del r.take_fallback
        require(res.get("fabric_path") == "fallback"
                and fell_back == [chosen.replica_id]
                and paths()["fallback"] == before["fallback"] + 1
                and ti.SERVE_KV_MIGRATION_FAILURES.value()
                == failures0 + 1,
                f"torn migration: path {res.get('fabric_path')}, fell "
                f"back on {fell_back} (router chose {chosen.replica_id})")
        out["torn"] = {"fell_back_on": fell_back,
                       "tie_gap": answered("torn request", [
                           (torn, res["tokens"][0], None)])}

        # the prefill replica killed with heavy requests in flight
        killed = [Request(prompt(L.heavy_lens[i % 2]),
                          max_new_tokens=L.new_tokens)
                  for i in range(L.kill_requests)]
        before = paths()
        for r in killed:
            router.submit(r)
        deadline = time.monotonic() + 60
        while not any(r._done.is_set() for r in killed) and not any(
                s is not None for s in prefill.engine._slots):
            require(time.monotonic() < deadline, "no request started")
            time.sleep(0.001)
        prefill.kill()
        for r in killed:
            r.wait(timeout=600)
        out["prefill_killed"] = {
            "requests": len(killed),
            "paths": {k: paths()[k] - v for k, v in before.items()},
            "tie_gap_max": answered("request past the prefill kill",
                                    done(killed))}
    finally:
        router.stop()
        for r in replicas:
            r.stop()
    for r in replicas:
        require(r.engine.pool.used() == 0,
                f"{r.replica_id}: {r.engine.pool.used()} blocks held "
                "after stop")
    out["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                          if on_card else None)
    out["seconds"] = time.perf_counter() - t_phase
    emit("fabric", **out)
    del replicas, prefill, decodes, params, router
    _collect(on_card)
    return out


# ----------------------------------------------------------------- forward --

# bf16 rounding of the whole model: on a reduced-width CPU proxy both
# attention paths sat as far from an f32 model as from each other
# (max |diff| 0.06 at 8 layers, |logits| <= 4.7, relative L2 1.1%).
LOGITS_MAX_ABS = 0.5
LOGITS_REL_L2 = 0.05


def forward_main(model: str = "tpu_1b", B: int = 4, S: int = 2048,
                 device: str = "cuda"):
    import torch

    from cloudtik_tpu_torch.models import transformer as T

    cfg = T.config(model)
    gen = torch.Generator(device=device).manual_seed(0)
    params = T.init_params(gen, cfg, device)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=device)
    with torch.no_grad():
        logits = T.forward(params, tokens, cfg)
    logits.cpu()   # waits for the device
    return cfg, params, tokens, logits


def phase_forward(cfg, params, tokens, logits, launches: int) -> dict:
    import torch

    from cloudtik_tpu_torch.models import transformer as T

    B, S = tokens.shape
    require(tuple(logits.shape) == (B, S, cfg.vocab_size),
            f"logits shape {tuple(logits.shape)}")
    require(logits.dtype == torch.float32, f"logits dtype {logits.dtype}")
    require(bool(torch.isfinite(logits).all()), "non-finite logits")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            T.forward(params, tokens, cfg)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        ref_cfg = dataclasses.replace(cfg, attention_impl="reference")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = T.forward(params, tokens, ref_cfg)
        torch.cuda.synchronize()
        ref_ms = (time.perf_counter() - t0) * 1e3
    diff = (logits - ref).abs().max().item()
    rel = ((logits - ref).norm() / ref.norm()).item()
    out = {"model": "tpu_1b", "batch": B, "seq": S, "dtype": "bfloat16",
           "flash_launches": launches, "ms_per_forward": ms,
           "reference_attention_ms": ref_ms,
           "tokens_per_s": B * S / (min(ms) / 1e3),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "logits_max_abs": ref.abs().max().item(),
           "logits_max_abs_diff_vs_reference": diff,
           "logits_rel_l2_vs_reference": rel,
           "tolerance": {"max_abs": LOGITS_MAX_ABS, "rel_l2": LOGITS_REL_L2}}
    emit("forward", **out)
    require(diff <= LOGITS_MAX_ABS and rel <= LOGITS_REL_L2,
            f"forward logits differ from the reference path: max {diff}, "
            f"rel {rel}")
    return out


# ------------------------------------------------------------------- train --

def _launch_counts() -> dict:
    from cloudtik_tpu_torch.ops import flash_attention as FA

    return {"flash_fwd": FA.LAUNCHES, "flash_bwd_dq": FA.LAUNCHES_DQ,
            "flash_bwd_dkv": FA.LAUNCHES_DKV}


def _zero_launch_counts() -> None:
    from cloudtik_tpu_torch.ops import flash_attention as FA

    FA.LAUNCHES = FA.LAUNCHES_DQ = FA.LAUNCHES_DKV = 0


def _train_measured(trainer, data, warmup: int, steps: int,
                    on_card: bool, detection: bool = False) -> dict:
    """`warmup` steps, then `steps` measured steps in one log window with
    the launch counts zeroed just before and read just after (with
    `detection`, B4's and B5's too), both off the iterator `data`.
    "losses" are the warm-up windows' losses and the measured window's
    last; "last" is that window's history entry; data_wait per measured
    step comes from the goodput ledger."""
    import torch

    from cloudtik_tpu_torch.telemetry import goodput

    t0 = time.perf_counter()
    warm = trainer.fit(data, warmup)["history"]
    warmup_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    trainer.config.log_every = steps
    _zero_launch_counts()
    if detection:
        _zero_det_launch_counts()
    wait0 = goodput.LEDGER.total(goodput.BUCKET_DATA_WAIT)
    t0 = time.perf_counter()
    entry = trainer.fit(data, steps)["history"][-1]   # ends in float()
    wall_s = time.perf_counter() - t0
    launches = _launch_counts()
    if detection:
        launches.update(_det_launch_counts())
    wait_s = goodput.LEDGER.total(goodput.BUCKET_DATA_WAIT) - wait0
    return {
        "warmup_steps": warmup, "measured_steps": steps,
        "warmup_s": warmup_s, "ms_per_step": wall_s / steps * 1e3,
        "tokens_per_s": entry["tokens_per_sec"], "mfu": entry.get("mfu"),
        "losses": [h["loss"] for h in warm] + [entry["loss"]],
        "last": entry, "history": warm + [entry], "launches": launches,
        "launches_per_step": {k: n / steps for k, n in launches.items()},
        "data_wait_ms_per_step": wait_s / steps * 1e3,
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if on_card else None)}


def phase_train(model: str = "tpu_1b", B: int = 8, S: int = 2048,
                device: str = "cuda", warmup: int = 2,
                steps: int = 5) -> dict:
    """bench.py's training configuration on the port: `warmup` steps, then
    the counts zeroed, `steps` measured steps, the counts read."""
    import torch

    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.train.data import synthetic_lm_batches
    from cloudtik_tpu_torch.train.optim import OptimizerConfig
    from cloudtik_tpu_torch.train.trainer import (
        Trainer, TrainerConfig, transformer_spec)

    cfg = T.config(model, max_seq_len=S, param_dtype=torch.bfloat16)
    trainer = Trainer(transformer_spec(cfg), TrainerConfig(
        global_batch_size=B, seq_len=S,
        optimizer=OptimizerConfig(moment_dtype="bfloat16"),
        log_every=steps), device=device)
    trainer.init_state(torch.Generator(device=device).manual_seed(0))
    # ---- the training path: counts zeroed just before, read just after --
    train = _train_measured(trainer, synthetic_lm_batches(
        B, S, cfg.vocab_size), warmup, steps, device == "cuda")
    entry = train.pop("last")
    result = {
        "model": model, "batch": B, "seq": S, "param_dtype": "bfloat16",
        "moment_dtype": "bfloat16", "remat_policy": cfg.remat_policy,
        **train, "flops_per_token": cfg.flops_per_token(),
        "loss": entry["loss"], "grad_norm": entry["grad_norm"],
    }
    emit("train", **result)
    require(math.isfinite(entry["loss"]), f"train loss {entry['loss']}")
    return result


# Gradients of the flash path against the reference attention path, tpu_1b
# width with 2 layers, bf16 compute on f32 params: the two paths round p
# and o to bf16 at different places, which moves each gradient leaf by
# about 1e-2 relative L2; 5e-2 holds that with room and fails on any wrong
# kernel term.
GRADS_REL_L2 = 5e-2


def phase_train_grads(model: str = "tpu_1b", n_layers: int = 2, B: int = 2,
                      S: int = 2048, device: str = "cuda",
                      loss_steps: int = 10) -> dict:
    import dataclasses

    import torch

    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.train.data import synthetic_lm_batches
    from cloudtik_tpu_torch.train.optim import OptimizerConfig
    from cloudtik_tpu_torch.train.trainer import (
        Trainer, TrainerConfig, transformer_spec)
    from cloudtik_tpu_torch.tree import tree_leaves

    cfg = T.config(model, n_layers=n_layers, max_seq_len=S)
    gen = torch.Generator(device=device).manual_seed(0)
    params = T.init_params(gen, cfg, device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = next(synthetic_lm_batches(B, S, cfg.vocab_size, seed=1))
    batch = {k: torch.as_tensor(v).to(device, torch.long)
             for k, v in batch.items()}
    names = [f"{top}.{k}" if isinstance(v, dict) else top
             for top, v in params.items()
             for k in (v if isinstance(v, dict) else [None])]
    grads = {}
    for impl in ("flash", "reference"):
        icfg = dataclasses.replace(cfg, attention_impl=impl)
        loss, _ = T.loss_fn(params, batch, icfg)
        grads[impl] = (loss.item(), torch.autograd.grad(
            loss, tree_leaves(params)))
    rel = {n: ((a.float() - b.float()).norm() / b.float().norm()).item()
           for n, a, b in zip(names, grads["flash"][1],
                              grads["reference"][1])}
    finite = all(_all_finite(g) for g in grads["flash"][1])
    del grads["flash"], grads["reference"]

    trainer = Trainer(transformer_spec(cfg), TrainerConfig(
        global_batch_size=B, seq_len=S, log_every=1,
        optimizer=OptimizerConfig(learning_rate=1e-3, warmup_steps=1,
                                  schedule="constant")), device=device)
    trainer.init_state(params=params)
    host_batch = next(synthetic_lm_batches(B, S, cfg.vocab_size, seed=1))
    history = trainer.fit(iter([host_batch] * loss_steps),
                          loss_steps)["history"]
    losses = [h["loss"] for h in history]
    out = {"model": model, "n_layers": n_layers, "batch": B, "seq": S,
           "grad_rel_l2_flash_vs_reference": rel,
           "tolerance_rel_l2": GRADS_REL_L2, "grads_finite": finite,
           "repeated_batch_losses": losses}
    emit("train_grads", **out)
    require(finite, "non-finite gradients on the flash path")
    worst = max(rel.values())
    require(worst <= GRADS_REL_L2,
            f"flash-path gradients differ from the reference path's: {rel}")
    require(all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0] - 0.1,
            f"loss did not fall on a repeated batch: {losses}")
    return out


# ----------------------------------------------------------- lora_train --

@dataclasses.dataclass(frozen=True)
class LoraTrainLoad:
    """The lora_train phase: `recipes.llama_lora_finetune.build` at the
    recipe's defaults (tpu_1b, rank 16, B=8, S=2048, f32 base) plus
    `argv`, AdamW at `lr` with no warmup (the default warmup of 100 steps
    gives a learning rate of ~0 to a run of a few steps), `warmup` steps
    then `steps` measured ones on one repeated batch; then the adapter,
    saved by the port's Checkpointer, served through
    `engine_backend(adapters_dir=...)` beside the base: one request on
    the adapter and one on the base for each of `serve_prompts`."""
    argv: tuple = ()
    lr: float = 3e-3
    warmup: int = 2
    steps: int = 6
    serve_prompts: tuple = (32, 96, 160, 224)
    serve_new: int = 24
    slots: int = 4
    max_len: int = 512
    block_size: int = 16


LORA_TRAIN_LOAD = LoraTrainLoad()
# the CPU rehearsal at `tiny`
LORA_TRAIN_REHEARSAL = LoraTrainLoad(
    argv=("--model", "tiny", "--seq-len", "64", "--batch", "4"), lr=1e-2,
    serve_prompts=(8, 16, 24, 32), serve_new=6, max_len=128, block_size=8)
# The trained adapter must move the teacher's logits (merged weights
# against the base's, over one prompt and the base's own answer) by twice
# the logits check's limit: then an answer the server decoded on the base
# weights, or on a fresh adapter (b = 0: a delta of exactly 0), sits at
# least one limit from the trained teacher and fails the check.
LORA_TRAIN_MIN_EFFECT = 2 * ENGINE_LOGITS_MAX_ABS


def _check_losses(name: str, losses: list) -> None:
    require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
            f"{name}: the loss did not fall on a repeated batch: {losses}")


def phase_lora_train(load: LoraTrainLoad = LORA_TRAIN_LOAD,
                     device: str = "cuda", nvidia_smi: str = None) -> dict:
    """LoRA fine-tuning through the recipe's `build`, then the trained
    adapter saved and served.  Launch counts are zeroed just before the
    measured steps and read just after."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from cloudtik_tpu_torch.models import generate as G
    from cloudtik_tpu_torch.models import lora as LO
    from cloudtik_tpu_torch.recipes import llama_lora_finetune as R
    from cloudtik_tpu_torch.serve.server import ServeServer, engine_backend
    from cloudtik_tpu_torch.train.checkpoint import (CheckpointConfig,
                                                     Checkpointer)
    from cloudtik_tpu_torch.train.optim import OptimizerConfig
    from cloudtik_tpu_torch.tree import tree_leaves, tree_map

    on_card = device == "cuda"
    L = load
    _collect(on_card)
    args = R.parser().parse_args(
        ["--device", device, "--log-every", "1", *L.argv])
    trainer, data, cfg, base, lora_cfg = R.build(args, OptimizerConfig(
        learning_rate=L.lr, warmup_steps=0, total_steps=1000))
    trainer.init_state(torch.Generator(device=device).manual_seed(1))
    base_before = tree_map(torch.clone, base)
    start = tree_map(lambda p: p.detach().clone(), trainer.params)
    train = _train_measured(trainer, itertools.repeat(next(data)), L.warmup,
                            L.steps, on_card)
    base_unchanged = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(base), tree_leaves(base_before)))
    adapters_changed = all(not torch.equal(a.detach(), b) for a, b in zip(
        tree_leaves(trainer.params), tree_leaves(start)))
    del base_before, start
    entry = train.pop("last")
    out = {"model": args.model, "nvidia_smi": nvidia_smi,
           "n_layers": cfg.n_layers, "rank": lora_cfg.rank,
           "alpha": lora_cfg.alpha, "targets": list(lora_cfg.targets),
           "batch": args.batch, "seq": args.seq_len,
           "base_dtype": str(cfg.param_dtype).replace("torch.", ""),
           "optimizer": {"name": "adamw", "lr": L.lr, "warmup_steps": 0},
           "adapter_params": sum(p.numel()
                                 for p in tree_leaves(trainer.params)),
           "flops_per_token": trainer.spec.flops_per_token, **train,
           "grad_norm": entry["grad_norm"],
           "base_unchanged": base_unchanged,
           "adapters_changed": adapters_changed}
    require(base_unchanged, "lora_train: a base leaf changed")
    require(adapters_changed, "lora_train: an adapter leaf did not move")
    _check_losses("lora_train", out["losses"])

    # the trained adapter: saved, then served beside the base
    adapter = tree_map(lambda p: p.detach(), trainer.params)
    merged = dict(base, layers=LO.merge_lora(base["layers"], adapter,
                                             lora_cfg))
    rng = np.random.default_rng(3)
    V = cfg.vocab_size
    prompts = [rng.integers(0, V, n).tolist() for n in L.serve_prompts * 2]
    with torch.no_grad():
        base_answer = G.generate(base, torch.tensor([prompts[0]],
                                                    device=device), cfg,
                                 max_new_tokens=L.serve_new)[0].tolist()
    effect = float((teacher_logits(merged, cfg, prompts[0], base_answer,
                                   device)
                    - teacher_logits(base, cfg, prompts[0], base_answer,
                                     device)).abs().max())
    out["adapter_effect"] = effect
    out["adapter_effect_limit"] = LORA_TRAIN_MIN_EFFECT
    require(effect >= LORA_TRAIN_MIN_EFFECT,
            f"lora_train: the trained adapter moves the teacher's logits by "
            f"only {effect} (limit {LORA_TRAIN_MIN_EFFECT})")
    root = tempfile.mkdtemp(prefix="tik-lora-train-")
    backend = server = None
    try:
        adapters_dir = os.path.join(root, "adapters")
        ckpt = Checkpointer(CheckpointConfig(
            directory=os.path.join(adapters_dir, "trained")))
        ckpt.save(trainer.step, {"params": trainer.params}, force=True)
        ckpt.close()
        del trainer
        _collect(on_card)
        backend = engine_backend(
            args.model, slots=L.slots, max_len=L.max_len,
            block_size=L.block_size, adapters_dir=adapters_dir,
            lora_rank=lora_cfg.rank, lora_alpha=lora_cfg.alpha,
            params=base, device=device, max_seq_len=args.seq_len)
        engine = backend.engine
        server = ServeServer([backend], host="127.0.0.1", port=0)
        server.start()
        url = f"http://127.0.0.1:{server.port}/v1/generate"
        payloads = [dict({"tokens": [p], "max_new_tokens": L.serve_new},
                         **({"adapter": "trained"} if i % 2 == 0 else {}))
                    for i, p in enumerate(prompts)]
        with StepLogits(engine) as rec:
            wall, reqs, _ = _serve_wave(engine, url, payloads)
    finally:
        if server is not None:
            server.stop()
        if backend is not None:
            backend.engine.stop()
        shutil.rmtree(root, ignore_errors=True)
    gaps, diffs = zip(*[check_rows(
        f"lora_train request {i}", merged if r.adapter_id else base, cfg, r,
        rec.rows(r.request_id), device) for i, r in enumerate(reqs)])
    require(engine.pool.used() == 0 and not engine._adapters._ref,
            "lora_train: KV or adapter pool not free after stop")
    n = sum(len(r.tokens) for r in reqs)
    out["serve"] = {"requests": len(reqs),
                    "on_adapter": sum(bool(r.adapter_id) for r in reqs),
                    "wall_s": wall, "tokens_per_s": n / wall,
                    "tie_gap_max": max(gaps), "logits_diff_max": max(diffs)}
    emit("lora_train", **out)
    del backend, engine, merged, base, reqs, rec
    _collect(on_card)
    return out


# ------------------------------------------------------------------- bert --

@dataclasses.dataclass(frozen=True)
class BertLoad:
    """The bert phase: `recipes.bert_large_pretrain.build`
    (bert_large, S=512, f32 params with bf16 compute) plus `argv` (B=32,
    16,384 tokens a step as the train phase's), AdamW at `lr` with no
    warmup, `warmup` then `steps` measured steps on one repeated batch."""
    argv: tuple = ("--batch", "32")
    lr: float = 1e-4
    warmup: int = 2
    steps: int = 5


BERT_LOAD = BertLoad()
BERT_REHEARSAL = BertLoad(argv=("--model", "tiny", "--seq-len", "64",
                                "--batch", "4"), lr=1e-3)


def phase_bert(load: BertLoad = BERT_LOAD, device: str = "cuda",
               nvidia_smi: str = None) -> dict:
    """BERT MLM pretraining through the recipe's `build`.  Launch counts
    are zeroed just before the measured steps and read just after."""
    import torch

    from cloudtik_tpu_torch.recipes import bert_large_pretrain as R
    from cloudtik_tpu_torch.train.optim import OptimizerConfig

    on_card = device == "cuda"
    _collect(on_card)
    args = R.parser().parse_args(
        ["--device", device, "--log-every", "1", *load.argv])
    trainer, data, cfg = R.build(args, OptimizerConfig(
        learning_rate=load.lr, warmup_steps=0, total_steps=1000))
    trainer.init_state(torch.Generator(device=device).manual_seed(0))
    batch = next(data)
    train = _train_measured(trainer, itertools.repeat(batch), load.warmup,
                            load.steps, on_card)
    entry = train.pop("last")
    out = {"model": args.model, "nvidia_smi": nvidia_smi,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": cfg.n_heads, "head_dim": cfg.head_dim,
           "batch": args.batch, "seq": args.seq_len,
           "masked_per_seq": batch["mlm_positions"].shape[1],
           "param_dtype": str(cfg.param_dtype).replace("torch.", ""),
           "dtype": str(cfg.dtype).replace("torch.", ""),
           "optimizer": {"name": "adamw", "lr": load.lr, "warmup_steps": 0},
           "params": cfg.num_params(),
           "flops_per_token": cfg.flops_per_token(), **train,
           "mlm_accuracy": entry["mlm_accuracy"],
           "grad_norm": entry["grad_norm"]}
    emit("bert", **out)
    _check_losses("bert", out["losses"])
    del trainer
    _collect(on_card)
    return out


# BERT's key bias gets a zero gradient in exact arithmetic (a bias on k
# adds one score to every key of a query, which the softmax cancels), so
# both paths return rounding noise there: it is held to 1e-2 of the
# largest leaf's gradient norm instead of its own.
BERT_ZERO_GRADS = ("layers.bk",)


def phase_bert_grads(model: str = "bert_large", n_layers: int = 2,
                     B: int = 4, S: int = 512, device: str = "cuda",
                     loss_steps: int = 10) -> dict:
    """bert_large width with `n_layers` layers: the flash path's
    gradients against the reference attention path's (GRADS_REL_L2 per
    leaf, as train_grads), and the loss falling over `loss_steps` steps
    on one repeated batch."""
    import torch

    from cloudtik_tpu_torch.models import bert as BE
    from cloudtik_tpu_torch.train.data import synthetic_mlm_batches
    from cloudtik_tpu_torch.train.optim import OptimizerConfig
    from cloudtik_tpu_torch.train.trainer import (
        Trainer, TrainerConfig, bert_spec)
    from cloudtik_tpu_torch.tree import tree_leaves

    cfg = BE.config(model, n_layers=n_layers, max_seq_len=S)
    gen = torch.Generator(device=device).manual_seed(0)
    params = BE.init_params(gen, cfg, device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    host_batch = next(synthetic_mlm_batches(B, S, cfg.vocab_size, seed=1))
    batch = {k: torch.as_tensor(v).to(device, torch.long)
             for k, v in host_batch.items()}
    names = [f"{top}.{k}" if isinstance(v, dict) else top
             for top, v in params.items()
             for k in (v if isinstance(v, dict) else [None])]
    grads = {}
    for impl in ("flash", "reference"):
        icfg = dataclasses.replace(cfg, attention_impl=impl)
        loss, _ = BE.loss_fn(params, batch, icfg)
        grads[impl] = torch.autograd.grad(
            loss, tree_leaves(params), allow_unused=True,
            materialize_grads=True)
    scale = max(g.float().norm().item() for g in grads["reference"])
    rel, zero = {}, {}
    for n, a, b in zip(names, grads["flash"], grads["reference"]):
        err = (a.float() - b.float()).norm().item()
        if n in BERT_ZERO_GRADS:
            zero[n] = max(a.float().norm().item(),
                          b.float().norm().item()) / scale
        elif b.float().norm().item() > 0:
            rel[n] = err / b.float().norm().item()
        else:   # mlm_bias: never read, zero on both paths
            require(a.float().norm().item() == 0,
                    f"bert_grads: {n} has a gradient on the flash path")
    finite = all(_all_finite(g) for g in grads["flash"])
    del grads

    trainer = Trainer(bert_spec(cfg), TrainerConfig(
        global_batch_size=B, seq_len=S, log_every=1,
        optimizer=OptimizerConfig(learning_rate=1e-3, warmup_steps=1,
                                  schedule="constant")), device=device)
    trainer.init_state(params=params)
    history = trainer.fit(iter([host_batch] * loss_steps),
                          loss_steps)["history"]
    losses = [h["loss"] for h in history]
    out = {"model": model, "n_layers": n_layers, "batch": B, "seq": S,
           "grad_rel_l2_flash_vs_reference": rel,
           "zero_grad_leaves_over_largest_norm": zero,
           "tolerance_rel_l2": GRADS_REL_L2, "tolerance_zero_leaves": 1e-2,
           "grads_finite": finite, "repeated_batch_losses": losses}
    emit("bert_grads", **out)
    require(finite, "bert_grads: non-finite gradients on the flash path")
    require(max(rel.values()) <= GRADS_REL_L2,
            f"bert_grads: flash-path gradients differ from the reference "
            f"path's: {rel}")
    require(max(zero.values()) <= 1e-2,
            f"bert_grads: the zero-gradient leaves are not small: {zero}")
    require(all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0] - 0.1,
            f"bert_grads: loss did not fall on a repeated batch: {losses}")
    return out


# ------------------------------------------------------------------ optim --

# Each optimizer on the card against the same optimizer on the CPU in f32,
# from one state and on the same gradients.  Held per leaf by the L2 of
# the difference over the L2 of the total update (what the 5 updates moved
# the leaf): the card's reductions (the global norm that scales the clip,
# Adafactor's row and column means and rms) sum in another order, moving
# an update by ~1e-7 of itself; AdamW's bf16 mu rounds to bf16 on both
# sides, but a last-bit difference of its f32 input may flip a rounding,
# 2**-8 of that element's update; Lion's sign flips where its argument
# lies within that noise of zero, 2 lr on a handful of elements.  1e-3
# holds all three with room and fails on a wrong term or a stale state.
OPTIM_CASES = (("sgd", None), ("adafactor", None), ("lion", None),
               ("adamw", "bfloat16"))
OPTIM_REL_L2 = 1e-3


def phase_optim(model: str = "tpu_1b", n_layers: int = 2, steps: int = 5,
                device: str = "cuda", lr: float = 1e-3,
                nvidia_smi: str = None) -> dict:
    """`make_optimizer`'s sgd, adafactor, lion and adamw (bf16 moments)
    over the layer stack and final norm of a `n_layers`-layer model at
    `model` width, `steps` updates of gradients drawn N(0, 1e-3) (a
    global norm over 1, so the clip acts), on `device` and on the CPU."""
    import torch

    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.train.optim import (OptimizerConfig,
                                                make_optimizer)
    from cloudtik_tpu_torch.tree import tree_leaves, tree_map

    on_card = device == "cuda"
    cfg = T.config(model, n_layers=n_layers)
    full = T.init_params(torch.Generator(device=device).manual_seed(0), cfg,
                         device)
    params0 = {"layers": full["layers"], "final_norm": full["final_norm"]}
    del full
    gen = torch.Generator(device=device).manual_seed(5)
    grads = [tree_map(lambda p: torch.randn(
        p.shape, generator=gen, device=device) * 1e-3, params0)
        for _ in range(steps)]
    names = [f"layers.{k}" for k in params0["layers"]] + ["final_norm"]

    def run(where):
        params = tree_map(lambda t: t.to(where, copy=True), params0)
        opt = make_optimizer(ocfg)
        state = opt.init(params)
        for g in grads:
            updates, state, _ = opt.update(
                tree_map(lambda t: t.to(where), g), state, params)
            tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
        if where != "cpu" and on_card:
            torch.cuda.synchronize()
        return params, state

    out = {"model": model, "n_layers": n_layers, "steps": steps, "lr": lr,
           "nvidia_smi": nvidia_smi,
           "params": sum(p.numel() for p in tree_leaves(params0)),
           "tolerance_rel_l2": OPTIM_REL_L2, "cases": {}}
    p0 = tree_map(lambda p: p.cpu(), params0)
    for name, moment_dtype in OPTIM_CASES:
        ocfg = OptimizerConfig(name=name, learning_rate=lr, warmup_steps=0,
                               total_steps=1000, moment_dtype=moment_dtype)
        t0 = time.perf_counter()
        got, state = run(device)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want, _ = run("cpu")
        cpu_s = time.perf_counter() - t0
        rel = {}
        for n, a, b, p in zip(names, tree_leaves(got), tree_leaves(want),
                              tree_leaves(p0)):
            moved = (b - p).norm().item()
            rel[n] = (a.cpu() - b).norm().item() / moved
        out["cases"][f"{name}/{moment_dtype or 'float32'}"] = {
            "count": state["count"], "rel_l2": rel,
            "max_rel_l2": max(rel.values()),
            "card_s": card_s, "cpu_s": cpu_s}
        require(state["count"] == steps and max(rel.values())
                <= OPTIM_REL_L2, f"optim {name}: the card's updates differ "
                f"from the CPU's: {rel}")
        del got, want, state
    emit("optim", **out)
    return out


# -------------------------------------------------------------- checkpoint --

@dataclasses.dataclass(frozen=True)
class CheckpointLoad:
    """The checkpoint phase: the train phase's configuration (bf16 params
    and moments, save_attn) trained `steps` steps in one `fit` with a
    checkpoint every `every`, the save at `torn_step` torn right after it
    commits; then `serve_prompts` prompts of `serve_prompt` tokens and
    `serve_new` new ones through both backends on the restored weights."""
    model: str = "tpu_1b"
    batch: int = 8
    seq: int = 2048
    every: int = 2
    steps: int = 4
    torn_step: int = 4
    serve_prompts: int = 4
    serve_prompt: int = 128
    serve_new: int = 16


CHECKPOINT_LOAD = CheckpointLoad()
CHECKPOINT_REHEARSAL = CheckpointLoad(model="tiny", batch=2, seq=32,
                                      serve_prompt=8, serve_new=6)


def _span_seconds(name: str, part=None) -> dict:
    """{step: seconds} of the finished `name` spans (with attrs part ==
    `part` when given)."""
    from cloudtik_tpu_torch import telemetry

    return {r["attrs"]["step"]: r["dur"] for r in telemetry.spans()
            if r["name"] == name and "step" in r["attrs"]
            and (part is None or r["attrs"].get("part") == part)}


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).iterdir())


def _drop_page_cache(path) -> None:
    """Evict the cached pages of every file under `path` (posix_fadvise
    DONTNEED: a committed step's files are fsynced, so their pages are
    clean), so that the next read comes from the disk."""
    for f in Path(path).rglob("*"):
        if f.is_file():
            fd = os.open(f, os.O_RDONLY)
            try:
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            finally:
                os.close(fd)


def _step_timer(trainer, on_card: bool) -> list:
    """Wrap `trainer.train_step` so that it records a CUDA event on the
    current stream just before and just after each step; returns the list
    of (start, end) events it fills (none off the card)."""
    import torch

    marks = []
    train_step = trainer.train_step

    def timed(batch):
        if not on_card:
            return train_step(batch)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = train_step(batch)
        end.record()
        marks.append((start, end))
        return out

    trainer.train_step = timed
    return marks


def _step_ms(marks) -> dict:
    """Device ms of each step, and of each gap up to the next step's start
    (what the loop queues between two steps, such as a snapshot's clone),
    from `_step_timer`'s events after a synchronize."""
    return {"step_ms": [s.elapsed_time(e) for s, e in marks],
            "between_ms": [e.elapsed_time(s) for (_, e), (s, _)
                           in zip(marks, marks[1:])]}


def _leaf_gap(got, want) -> float:
    """Max abs difference over the leaves of two trees of one structure
    (`want` on the host): 0.0 only when every leaf is `torch.equal`, inf
    when a leaf differs by no finite amount (a NaN, a Python value)."""
    import torch

    from cloudtik_tpu_torch.tree import tree_leaves

    got, want = tree_leaves(got), tree_leaves(want)
    require(len(got) == len(want),
            f"{len(got)} leaves against the reference's {len(want)}")
    gap = 0.0
    for a, b in zip(got, want):
        if not isinstance(a, torch.Tensor):
            gap = gap if a == b else math.inf
            continue
        a = a.cpu()
        if not torch.equal(a, b):
            d = (a.float() - b.float()).abs().max().item()
            gap = max(gap, d) if d > 0 else math.inf
    return gap


def phase_checkpoint(load: CheckpointLoad = CHECKPOINT_LOAD,
                     device: str = "cuda") -> dict:
    """Train, save off the step loop, tear a step, resume past it, serve
    the restored weights.  Launch counts are zeroed just before the
    resumed steps and read just after."""
    import itertools
    import shutil
    import tempfile

    import numpy as np
    import torch

    from cloudtik_tpu_torch import telemetry
    from cloudtik_tpu_torch.faults import seams
    from cloudtik_tpu_torch.faults.plan import FaultPlan, FaultPoint
    from cloudtik_tpu_torch.models import generate as G
    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.serve.server import (
        ServeServer, engine_backend, transformer_backend)
    from cloudtik_tpu_torch.telemetry import goodput
    from cloudtik_tpu_torch.train.checkpoint import restore_params
    from cloudtik_tpu_torch.train.data import synthetic_lm_batches
    from cloudtik_tpu_torch.train.optim import OptimizerConfig
    from cloudtik_tpu_torch.train.trainer import (
        Trainer, TrainerConfig, transformer_spec)
    from cloudtik_tpu_torch.tree import tree_leaves, tree_map

    on_card = device == "cuda"
    telemetry.enable()
    B, S = load.batch, load.seq
    cfg = T.config(load.model, max_seq_len=S, param_dtype=torch.bfloat16)
    root = tempfile.mkdtemp(prefix="tik-checkpoint-")
    ckpt_dir = str(Path(root) / "run")
    # one log window over a whole fit: nothing waits for the card between
    # steps, so a save's d2h runs under the steps after it, as in a long
    # run
    one_window = load.steps + 1

    def trainer_for(every: int, depth: int = 2,
                    log_every: int = 1) -> "Trainer":
        return Trainer(transformer_spec(cfg), TrainerConfig(
            global_batch_size=B, seq_len=S, log_every=log_every,
            optimizer=OptimizerConfig(moment_dtype="bfloat16"),
            checkpoint_every=every, checkpoint_dir=ckpt_dir,
            prefetch_depth=depth), device=device)

    def data(skip: int = 0):
        return itertools.islice(
            synthetic_lm_batches(B, S, cfg.vocab_size, seed=5), skip, None)

    def seed():
        return torch.Generator(device=device).manual_seed(0)

    def free_card():
        gc.collect()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def host_copy(tree):
        return tree_map(lambda t: t.detach().cpu().clone()
                        if isinstance(t, torch.Tensor) else t, tree)

    def losses(out):
        return [h["loss"] for h in out["history"]]

    def timed_s(fn):
        t0 = time.perf_counter()
        result = fn()
        return result, time.perf_counter() - t0

    out = {"model": load.model, "batch": B, "seq": S,
           "param_dtype": "bfloat16", "moment_dtype": "bfloat16",
           "remat_policy": cfg.remat_policy, "directory": root}
    try:
        # ---- room for max_to_keep + 1 steps of the saving trainer's
        # checkpointer, or a loud failure ----
        trainer = trainer_for(every=load.every, log_every=one_window)
        keep = trainer.checkpointer.config.max_to_keep
        state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(
            trainer._abstract_state()) if isinstance(t, torch.Tensor))
        free = shutil.disk_usage(root).free
        need = (keep + 1) * state_bytes
        out["disk"] = {"state_bytes": state_bytes, "free_bytes": free,
                       "max_to_keep": keep, "needed_bytes": need}
        require(free >= need, f"checkpoint phase: {free} bytes free under "
                f"{root}, {need} needed for {keep + 1} steps of "
                f"{state_bytes} bytes")

        # ---- determinism: `every` steps twice from one state (prefetch
        # 0 and 2), data_wait per step from the goodput ledger (log_every
        # 1: the callback runs after each step, so the pipeline's start,
        # step 1, stands apart); the prefetch-2 run goes on, uninterrupted,
        # to `steps`: its state at `every` and its losses are what the
        # saving run must restore and resume to ----
        buckets = (goodput.BUCKET_DATA_WAIT, goodput.BUCKET_HOST_TRANSFER)
        probe = trainer_for(every=0, depth=0)
        probe_losses, data_wait, at_save = {}, {}, {}
        for depth in (0, 2):
            probe.config.prefetch_depth = depth
            probe.init_state(seed())
            totals = [[goodput.LEDGER.total(b) for b in buckets]]
            probe_losses[depth] = losses(probe.fit(
                data(), load.every, callbacks=[
                    lambda _t, _e: totals.append(
                        [goodput.LEDGER.total(b) for b in buckets])]))
            per_step = [[(b - a) * 1e3 for a, b in zip(x, y)]
                        for x, y in zip(totals, totals[1:])]
            data_wait[depth] = {
                "data_wait_ms_by_step": [w for w, _ in per_step],
                "host_transfer_ms_by_step": [h for _, h in per_step]}
            at_save[depth] = host_copy(probe.state)
        uninterrupted = probe_losses[2] + losses(probe.fit(
            data(skip=load.every), load.steps - load.every))
        del probe
        free_card()
        loss_gap = max(abs(a - b) for a, b in zip(probe_losses[0],
                                                  probe_losses[2]))
        state_gap = _leaf_gap(at_save[0], at_save[2])
        require(math.isfinite(state_gap), "the two probe runs' states "
                "differ by no finite amount")
        saved = at_save.pop(2)
        del at_save
        deterministic = probe_losses[0] == probe_losses[2] \
            and state_gap == 0.0
        loss_tol = 0.0 if deterministic else 2 * loss_gap
        leaf_tol = 2 * state_gap
        out["determinism"] = {"losses": probe_losses,
                              "max_abs_loss_gap": loss_gap,
                              "max_abs_leaf_gap": state_gap,
                              "bitwise": deterministic,
                              "resume_tolerance": loss_tol,
                              "leaf_tolerance": leaf_tol}
        out["prefetch"] = {f"depth_{d}": v for d, v in data_wait.items()}

        # ---- the same fit with no save, step by step on the card's
        # clock: what the saving run's steps are held against ----
        nosave = trainer_for(every=0, log_every=one_window)
        nosave.init_state(seed())
        nosave_marks = _step_timer(nosave, on_card)
        nosave.fit(data(), load.steps)
        del nosave
        free_card()

        # ---- train and save in one fit, step `torn_step` torn; at each
        # save the peak since the last one (or the fit's start) is read
        # and the peak restarted once the snapshot is staged ----
        trainer.init_state(seed())
        ckpt = trainer.checkpointer
        marks = _step_timer(trainer, on_card)
        staged = []
        save = ckpt.save

        def measured_save(step, state, force=False):
            row = {"step": step}
            if on_card:
                row.update(
                    peak_before_gb=torch.cuda.max_memory_allocated() / 1e9,
                    allocated_before_gb=torch.cuda.memory_allocated() / 1e9)
            started = save(step, state, force)
            if started:
                if on_card:
                    row["allocated_after_gb"] = \
                        torch.cuda.memory_allocated() / 1e9
                    torch.cuda.reset_peak_memory_stats()
                staged.append(row)
            return started

        ckpt.save = measured_save
        plan = FaultPlan([FaultPoint("checkpoint.save", "torn_write",
                                     match={"step": load.torn_step})],
                         seed=7, name="checkpoint-phase")
        free_card()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        with seams.armed(plan):
            final = losses(trainer.fit(data(), load.steps))
            ckpt.wait()
        require([e for e in plan.trace if e["kind"] == "torn_write"],
                "the torn-write fault never fired")
        require(abs(final[-1] - uninterrupted[-1]) <= loss_tol,
                f"the saving run's last loss {final[-1]} differs from the "
                f"uninterrupted run's {uninterrupted[-1]} (tolerance "
                f"{loss_tol})")
        ckpt.close()
        steps_on_disk = ckpt.all_steps()
        step_bytes = {s: _dir_bytes(Path(ckpt_dir) / str(s))
                      for s in steps_on_disk}
        require(steps_on_disk == list(range(load.every, load.steps + 1,
                                            load.every)),
                f"steps on disk {steps_on_disk}")
        del trainer, ckpt
        free_card()

        # ---- resume past the torn step, from the disk ----
        resumed = trainer_for(every=1000)
        _drop_page_cache(ckpt_dir)
        step, resume_s = timed_s(resumed.maybe_resume)
        require(step == load.every, f"resumed at step {step}, expected "
                f"{load.every} (step {load.torn_step} is torn)")
        restored_gap = _leaf_gap(resumed.state, saved)
        require(restored_gap <= leaf_tol,
                f"restored leaves differ from the uninterrupted run's "
                f"state at step {load.every} by {restored_gap} (tolerance "
                f"{leaf_tol})")
        _zero_launch_counts()
        _zero_det_launch_counts()
        resumed_losses = losses(resumed.fit(data(skip=load.every),
                                            load.steps - load.every))
        launches = _launch_counts()
        det_launches = _det_launch_counts()
        require(not any(det_launches.values()),
                f"the checkpoint path launched {det_launches}, expected "
                "no detection kernel")
        diff = max(abs(a - b) for a, b in zip(
            resumed_losses, uninterrupted[load.every:]))
        out["resume"] = {"restored_step": step, "resume_s": resume_s,
                         "leaves": len(tree_leaves(saved)),
                         "max_abs_leaf_gap": restored_gap,
                         "uninterrupted_losses": uninterrupted,
                         "saving_run_last_loss": final[-1],
                         "resumed_losses": resumed_losses,
                         "max_abs_loss_diff": diff,
                         "tolerance": loss_tol}
        require(diff <= loss_tol,
                f"resumed losses {resumed_losses} differ from the "
                f"uninterrupted run's {uninterrupted[load.every:]} by "
                f"{diff} (tolerance {loss_tol})")
        out["launches"] = launches
        out["det_launches"] = det_launches
        out["launches_per_step"] = {
            k: n / (load.steps - load.every) for k, n in launches.items()}

        # ---- restore times, each read from the disk (page cache dropped
        # before it) but the second full one: past the torn step, which
        # goes (the torn file may be an optimizer leaf, which a
        # params-only read never opens), then full and params-only reads
        # of step `every` ----
        _drop_page_cache(ckpt_dir)
        (_state, good), past_torn_s = timed_s(
            lambda: resumed.checkpointer.restore_latest_good(
                resumed._abstract_state(), remove_unreadable=True,
                device=torch.device(device)))
        del _state
        require(good == load.every
                and resumed.checkpointer.all_steps() == [load.every],
                f"restore_latest_good gave step {good}, left "
                f"{resumed.checkpointer.all_steps()}")
        _drop_page_cache(ckpt_dir)
        _, full_s = timed_s(lambda: resumed.restore_checkpoint(load.every))
        _, full_warm_s = timed_s(
            lambda: resumed.restore_checkpoint(load.every))
        del resumed
        free_card()
        like = T.init_params(torch.Generator(), cfg, "meta")
        _drop_page_cache(ckpt_dir)
        params, params_s = timed_s(
            lambda: restore_params(ckpt_dir, like, torch.device(device)))
        require(_leaf_gap(params, saved["params"]) <= leaf_tol,
                "the params-only restore differs from the saved params")
        del params

        # ---- save costs: the host's enqueue and the write from the
        # spans; the stall as the card's time from the end of the saved
        # step to the end of the fit, against the fit with no save ----
        snap = _span_seconds("checkpoint.save", "snapshot")
        d2h = _span_seconds("checkpoint.d2h")
        write = _span_seconds("checkpoint.save", "write")
        inline = _span_seconds("checkpoint.save", "inline")
        pinned = [r["dur"] for r in telemetry.spans()
                  if r["name"] == "checkpoint.reserve"]
        gb = step_bytes[load.every] / 1e9
        stall = {}
        if on_card:
            def after_save_ms(m):
                return m[load.every - 1][1].elapsed_time(m[-1][1])

            steps_ms, nosave_ms = _step_ms(marks), _step_ms(nosave_marks)
            stall = {
                "stall_ms": after_save_ms(marks)
                - after_save_ms(nosave_marks),
                "after_save_ms": after_save_ms(marks),
                "after_save_no_save_ms": after_save_ms(nosave_marks),
                "clone_ms": steps_ms["between_ms"][load.every - 1]
                - nosave_ms["between_ms"][load.every - 1],
                "step_ms": steps_ms["step_ms"],
                "step_no_save_ms": nosave_ms["step_ms"]}
        out["save"] = {
            "step_dir_bytes": step_bytes[load.every],
            "torn_step_dir_bytes": step_bytes[load.torn_step],
            "offloaded": {"step": load.every,
                          "host_enqueue_ms": snap[load.every] * 1e3,
                          "stall_ms": stall.get("stall_ms"),
                          # the buffers pinned before the fit's first step
                          "pin_before_loop_s":
                          pinned[0] if pinned else None,
                          "d2h_s": d2h[load.every],
                          "d2h_gb_per_s": gb / d2h[load.every],
                          "write_s": write[load.every],
                          "write_gb_per_s": gb / write[load.every]},
            "card_time": stall or None,
            "torn_inline": {"step": load.torn_step,
                            "stall_s": inline[load.torn_step],
                            "d2h_s": d2h[load.torn_step],
                            "d2h_gb_per_s": gb / d2h[load.torn_step],
                            "write_s": write[load.torn_step]},
        }
        out["restore"] = {"cold_full_s": full_s,
                          "cold_full_gb_per_s": gb / full_s,
                          "warm_full_s": full_warm_s,
                          "cold_params_only_s": params_s,
                          "cold_full_past_torn_step_s": past_torn_s}
        first, torn = staged
        out["memory"] = {
            "peak_no_snapshot_gb": first.get("peak_before_gb"),
            "peak_with_snapshot_gb": torn.get("peak_before_gb"),
            "snapshot_gb": (first["allocated_after_gb"]
                            - first["allocated_before_gb"])
            if on_card else None,
            "snapshot_held_at_next_save_gb": (
                torn["allocated_before_gb"] - first["allocated_before_gb"])
            if on_card else None,
            "at_save": staged}

        # ---- serve the restored weights: plain backend and engine ----
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, cfg.vocab_size, (
            load.serve_prompts, load.serve_prompt)).tolist()
        overrides = dict(max_seq_len=S, param_dtype=torch.bfloat16)
        plain = transformer_backend(load.model, checkpoint_dir=ckpt_dir,
                                    device=device, **overrides)
        require(_leaf_gap(plain.params, saved["params"]) <= leaf_tol,
                "the served params differ from the saved ones")
        engine = engine_backend(
            load.model, checkpoint_dir=ckpt_dir, device=device, slots=4,
            max_len=load.serve_prompt + load.serve_new + 16, block_size=16,
            **overrides)
        served = {"plain": [], "engine": []}
        gaps = []
        try:
            for name, backend in (("plain", plain), ("engine", engine)):
                server = ServeServer([backend], host="127.0.0.1", port=0)
                server.start()
                try:
                    for prompt in prompts:
                        status, body = _http(
                            f"http://127.0.0.1:{server.port}/v1/generate",
                            {"tokens": [prompt],
                             "max_new_tokens": load.serve_new})
                        require(status == 200, f"{name}: status {status} "
                                f"{body}")
                        served[name].append(body["tokens"][0])
                finally:
                    server.stop()
            for prompt, plain_toks, eng_toks in zip(
                    prompts, served["plain"], served["engine"]):
                direct = G.generate(
                    plain.params, torch.tensor([prompt], device=device),
                    plain.cfg, max_new_tokens=load.serve_new)[0].tolist()
                require(plain_toks == direct, "served tokens differ from "
                        "a direct generate on the restored params")
                gaps.append(check_tie_aware("checkpoint engine", tie_gaps(
                    plain.params, plain.cfg, prompt, eng_toks, device)))
        finally:
            engine.engine.stop()
        out["serve"] = {"prompts": load.serve_prompts,
                        "prompt_len": load.serve_prompt,
                        "new_tokens": load.serve_new,
                        "plain_equals_direct_generate": True,
                        "engine_equal_to_plain": sum(
                            a == b for a, b in zip(served["plain"],
                                                   served["engine"])),
                        "engine_tie_gap_max": max(gaps),
                        "tie_gap_limit": ENGINE_TIE_GAP}
        del plain, engine
    finally:
        shutil.rmtree(root, ignore_errors=True)
    require(not Path(root).exists(), f"{root} was not removed")
    emit("checkpoint", **out)
    gc.collect()
    return out


# -------------------------------------------------------------- kernel_det --

# FP32 rate outside the tensor cores (NVIDIA data sheet), for NMS's bound.
PEAK_F32_FLOPS = 67e12


@dataclasses.dataclass(frozen=True)
class NmsCase:
    name: str
    B: int
    N: int
    K: int
    seed: int                 # numpy seed of the boxes and scores
    iou_threshold: float = 0.5
    scores: str = "uniform"   # "uniform" in [0, 1) or "zero"
    degenerate: bool = False  # zero-area, duplicate and inverted boxes
    # "nan_score", "nan_box", "signed_zero" or "inf_and_absent": the
    # reference's NaN, signed-zero and absent-score semantics
    special: str = ""


# The first two are the shapes `detect` gives the kernel: Mask R-CNN (8
# images of 128 proposals, 50 kept) and SSD (8 images of 3,000 anchors, 100
# kept); ssd1200_b8 is SSD at MLPerf's 1200 x 1200 input (45,384 anchors an
# image).  Keep lists must equal the plain version's and the JAX
# `nms_reference`'s (tests/torch_golden/) exactly.
NMS_CASES = (
    NmsCase("maskrcnn_b8", 8, 128, 50, seed=1),
    NmsCase("ssd_b8", 8, 3000, 100, seed=2),
    NmsCase("all_zero_scores", 8, 3000, 100, seed=3, scores="zero"),
    NmsCase("fewer_than_k", 4, 60, 100, seed=4, iou_threshold=0.3),
    NmsCase("degenerate", 4, 512, 64, seed=5, iou_threshold=0.3,
            degenerate=True),
    NmsCase("ssd1200_b8", 8, 45_384, 100, seed=6),
    NmsCase("all_zero_ssd1200", 8, 45_384, 100, seed=7, scores="zero"),
    NmsCase("nan_score", 4, 3000, 100, seed=8, special="nan_score"),
    NmsCase("nan_box", 4, 512, 64, seed=9, special="nan_box"),
    NmsCase("signed_zero", 4, 512, 64, seed=10, special="signed_zero"),
    NmsCase("inf_and_absent", 4, 3000, 100, seed=11,
            special="inf_and_absent"),
    # K past half of N: the scan runs through every band of both images
    NmsCase("many_kept", 2, 3000, 1500, seed=12, iou_threshold=0.9),
)
# the kernel_det cases at the shapes the detect paths give B4
NMS_DETECT_SHAPES = ("ssd_b8", "maskrcnn_b8", "ssd1200_b8")
# anchors of ssd_resnet34 at 1200 x 1200 (maps 75/38/19/10/5/3, 6 a cell)
SSD1200_ANCHORS = 45_384
# flops per (kept box, candidate): the IoU and its compare (2 min, 2 max,
# 2 sub, 2 clamps, mul, add, sub, max, div, compare)
NMS_FLOPS_PER_PAIR = 16
# The JAX `nms_reference` keep list of each case, made from its seed by
# tools/export_torch_golden.py
GOLDEN_DIR = Path(__file__).resolve().parent / "tests" / "torch_golden"
# what the hand-made first image of nan_box and signed_zero keeps
NAN_BOX_KEEP = [1, 0, -1]
SIGNED_ZERO_KEEP = [0, -1, -1]


def make_nms_arrays(c: NmsCase):
    """Normalized xyxy boxes [B, N, 4] and scores [B, N], f32 numpy arrays
    made from the case's seed with exact float arithmetic only (no
    transcendental), so that every machine makes the same bits."""
    import numpy as np

    f32 = np.float32
    rng = np.random.default_rng(c.seed)
    xy = rng.random((c.B, c.N, 2), dtype=f32) * f32(0.8)
    wh = rng.random((c.B, c.N, 2), dtype=f32) * f32(0.3) + f32(0.01)
    boxes = np.concatenate([xy, np.minimum(xy + wh, f32(1.0))], axis=-1)
    if c.scores == "zero":
        scores = np.zeros((c.B, c.N), f32)
    else:
        scores = rng.random((c.B, c.N), dtype=f32)
    if c.degenerate:
        q = c.N // 4
        boxes[:, :q, 2:] = boxes[:, :q, :2]               # zero area
        boxes[:, q:2 * q] = boxes[:, 2 * q:3 * q]         # duplicates ...
        scores[:, q:2 * q] = scores[:, 2 * q:3 * q]       # ... tied
        boxes[:, 3 * q:] = boxes[:, 3 * q:][..., [2, 3, 0, 1]]  # inverted
    u = rng.random((c.B, c.N))
    if c.special == "nan_score":
        # every image but the last holds one NaN score: it keeps nothing
        for b in range(c.B - 1):
            scores[b, (int(rng.integers(c.N)), 0, c.N - 1)[b % 3]] = np.nan
    elif c.special == "nan_box":
        # image 0 starts [[0,0,1,1], [NaN,0,1,1], [0,0,1,1]] at scores
        # [0.5, 0.9, 0.4], every other box absent; in the others one box
        # in ten has a NaN coordinate
        coord = rng.integers(0, 4, (c.B, c.N))
        rows, cols = np.nonzero(u < 0.1)
        boxes[rows, cols, coord[rows, cols]] = np.nan
        boxes[0, :3] = [[0, 0, 1, 1], [np.nan, 0, 1, 1], [0, 0, 1, 1]]
        scores[0] = -np.inf
        scores[0, :3] = [0.5, 0.9, 0.4]
    elif c.special == "signed_zero":
        # image 0 starts with three copies of one box at [-0.0, 0.0, 0.0],
        # every other box absent; the others hold +-0.0 ties and a tenth
        # of scores in [-0.5, 0.5)
        scores[:] = np.where(u < 0.45, f32(-0.0), f32(0.0))
        scores[u >= 0.9] = ((u[u >= 0.9] - 0.95) * 10).astype(f32)
        boxes[0, :3] = boxes[0, 0]
        scores[0] = -np.inf
        scores[0, :3] = [-0.0, 0.0, 0.0]
    elif c.special == "inf_and_absent":
        # +inf, and scores at or below -5e29 (absent) beside -4e29 (not);
        # the last image holds absent scores only
        for lo, hi, value in ((0.0, 0.01, np.inf), (0.01, 0.06, -np.inf),
                              (0.06, 0.11, -1e30), (0.11, 0.16, -5e29),
                              (0.16, 0.21, -6e29), (0.21, 0.26, -4e29)):
            scores[(u >= lo) & (u < hi)] = value
        if c.B > 1:
            scores[-1] = np.where(u[-1] < 0.5, f32(-np.inf), f32(-5e29))
    return boxes, scores


def make_nms_inputs(c: NmsCase, device: str):
    """`make_nms_arrays` as tensors on the device, as `detect` hands them
    to NMS."""
    import torch

    boxes, scores = make_nms_arrays(c)
    return (torch.from_numpy(boxes).to(device),
            torch.from_numpy(scores).to(device))


def golden_keep(c: NmsCase):
    """The JAX `nms_reference` keep list [B, K] committed for this case, or
    None when there is none for these inputs (a case cut to CPU size)."""
    import numpy as np

    path = GOLDEN_DIR / f"nms_{c.name}.npz"
    if not path.exists():
        return None
    g = np.load(path)
    same = (int(g["seed"]) == c.seed
            and tuple(int(x) for x in g["shape"]) == (c.B, c.N, c.K)
            and float(g["iou_threshold"]) == c.iou_threshold)
    return g["keep"] if same else None


def check_nms_case(c: NmsCase, keep, scores) -> None:
    """What each kind of case states beyond equality, on the keep list
    [B, K] (numpy) of scores [B, N] (numpy)."""
    import numpy as np

    if c.N < c.K:
        require(bool((keep[:, c.N:] == -1).all()),
                f"nms {c.name}: no -1 padding")
    if c.scores == "zero" and not c.special:
        require(bool((keep[:, 0] == 0).all()),
                f"nms {c.name}: ties not taken by lowest index")
    if c.special == "nan_score":
        require(bool((keep[:-1] == -1).all()) and bool((keep[-1] >= 0).any()),
                f"nms {c.name}: an image with a NaN score kept a box, or "
                "the clean image kept none")
    elif c.special == "nan_box":
        require(keep[0, :3].tolist() == NAN_BOX_KEEP,
                f"nms {c.name}: kept {keep[0, :3].tolist()}, expected "
                f"{NAN_BOX_KEEP}")
    elif c.special == "signed_zero":
        require(keep[0, :3].tolist() == SIGNED_ZERO_KEEP,
                f"nms {c.name}: kept {keep[0, :3].tolist()}, expected "
                f"{SIGNED_ZERO_KEEP}")
    elif c.special == "inf_and_absent":
        picked = np.take_along_axis(scores, np.maximum(keep, 0), axis=1)
        require(bool((picked[keep >= 0] > np.float32(-5e29)).all()),
                f"nms {c.name}: an absent score was kept")
        require(c.B == 1 or bool((keep[-1] == -1).all()),
                f"nms {c.name}: the image of absent scores kept a box")
        for b in range(c.B):
            inf = np.nonzero(scores[b] == np.inf)[0]
            require(len(inf) == 0 or keep[b, 0] == inf[0],
                    f"nms {c.name}: image {b} did not start at its first "
                    "+inf score")


def nms_scan_work(scores, keep):
    """What a scan in sorted order must do on these inputs, from the keep
    list [B, K] (numpy) of scores [B, N] (numpy): the candidates it reaches
    (through the K-th kept, or all of them) and the IoUs it takes, one for
    each (kept box, later candidate reached).  An image with a NaN score
    takes none.  Returns (candidates reached, IoU pairs), summed over the
    images."""
    import numpy as np

    K = keep.shape[1]
    reached = pairs = 0
    for s, k in zip(scores, keep):
        if np.isnan(s).any():
            continue
        cand = np.nonzero(s > np.float32(-5e29))[0]
        order = cand[np.lexsort((cand, -s[cand]))]   # -0.0 ties +0.0
        rank = np.empty(len(s), np.int64)
        rank[order] = np.arange(len(order))
        pos = rank[k[k >= 0]]
        n = int(pos[-1]) + 1 if len(pos) == K else len(order)
        reached += n
        pairs += int((n - 1 - pos).sum())
    return reached, pairs


def nms_bound(c: NmsCase, scores, keep):
    """Least time for the work these inputs need: each box (20 bytes) read
    once, each keep index written once; one IoU for each (kept box, later
    candidate) that the scan in sorted order reaches (`nms_scan_work`)."""
    _, pairs = nms_scan_work(scores, keep)
    flops = NMS_FLOPS_PER_PAIR * pairs
    nbytes = 20 * c.B * c.N + 4 * c.B * c.K
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def nms_steps_bound_ms(c: NmsCase, kept: int) -> float:
    """The bound that the rows of the earlier, argmax-loop design gave:
    `kept` greedy steps over all N boxes, or the bytes if more.  Kept under
    its own key, so that rows compare across designs."""
    t_ops = NMS_FLOPS_PER_PAIR * kept * c.N / PEAK_F32_FLOPS
    t_bytes = (20 * c.B * c.N + 4 * c.B * c.K) / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3


@dataclasses.dataclass(frozen=True)
class RoiCase:
    name: str
    B: int
    R: int
    C: int
    H: int
    P: int
    sampling: int
    scale: float = 1.0
    dtype: str = "bfloat16"
    # "nhwc": the detect path's [B, H, W, C] map permuted to [B, C, H, W]
    layout: str = "nhwc"
    rois: str = "proposals"   # "proposals", "outside" or "subpixel"
    # the route of csrc/roi_align.cu the kernel must take
    # (`detection.roi_align_route`): "vector" for a bf16 NHWC map whose C
    # is a multiple of 8, else "strided"
    route: str = "vector"


# The first two are the shapes Mask R-CNN's `roi_heads` gives the kernel: 8
# images x 128 proposals on the [8, 32, 32, 1024] bf16 C4 map, pooled to 7x7
# and 14x14 with sampling 1.  ragged_channels has a bf16 NHWC map of 100
# channels: its 200-byte pixel stride and its channel tail take the strided
# route.  channel_tail's 72 channels take the vector route with a last
# block of 8 channels.
ROI_CASES = (
    RoiCase("maskrcnn_7", 8, 128, 1024, 32, 7, 1),
    RoiCase("maskrcnn_14", 8, 128, 1024, 32, 14, 1),
    RoiCase("sampling2_scale025", 2, 64, 256, 64, 7, 2, scale=0.25,
            dtype="float32", layout="nchw", route="strided"),
    RoiCase("partly_outside", 2, 64, 256, 32, 7, 2, rois="outside"),
    RoiCase("subpixel", 2, 64, 96, 32, 7, 2, dtype="float32",
            rois="subpixel", route="strided"),
    RoiCase("ragged_channels", 2, 64, 100, 32, 14, 1, route="strided"),
    RoiCase("channel_tail", 2, 64, 72, 32, 7, 2),
)
# The shapes Mask R-CNN's training step gives ROIAlign (the maskrcnn_train
# phase: 4 images x 128 proposals on the bf16 C4 map), forward on the
# kernel and backward through `detection.roi_align_grad`
ROI_GRAD_CASES = (
    RoiCase("maskrcnn_train_7", 4, 128, 1024, 32, 7, 1),
    RoiCase("maskrcnn_train_14", 4, 128, 1024, 32, 14, 1),
)
# f32 outputs from the same (widened) inputs; only the order of the sums
# and the contraction of the bilinear weights differ; the same holds for
# the f32 gradients
ROI_ATOL = ROI_RTOL = 1e-5
ROI_FLOPS_PER_SAMPLE = 16   # 4 taps: weights, products, sum


def make_roi_inputs(c: RoiCase, gen, device: str):
    import torch

    dtype = getattr(torch, c.dtype)
    if c.layout == "nhwc":
        feats = torch.randn((c.B, c.H, c.H, c.C), generator=gen,
                            device=device).to(dtype).permute(0, 3, 1, 2)
    else:
        feats = torch.randn((c.B, c.C, c.H, c.H), generator=gen,
                            device=device).to(dtype)
    extent = c.H / c.scale           # input coordinates
    u = torch.rand((c.B, c.R, 4), generator=gen, device=device)
    if c.rois == "proposals":        # normalized boxes times the map size
        x1y1 = u[..., :2] * 0.9
        x2y2 = (x1y1 + 0.02 + u[..., 2:] * 0.5).clamp(max=1.0)
    elif c.rois == "outside":
        x1y1 = u[..., :2] - 0.5
        x2y2 = x1y1 + 0.3 + u[..., 2:] * 0.9
    else:                            # under a pixel: clamped to size 1
        x1y1 = u[..., :2]
        x2y2 = x1y1 + u[..., 2:] * 0.5 * c.scale
    return feats, (torch.cat([x1y1, x2y2], dim=-1) * extent).contiguous()


def roi_bound(c: RoiCase):
    """Least time: the map read once, rois read once, the f32 output
    written once; bilinear arithmetic on every sample."""
    elem = 2 if c.dtype == "bfloat16" else 4
    out = c.B * c.R * c.C * c.P * c.P
    flops = ROI_FLOPS_PER_SAMPLE * out * c.sampling ** 2
    nbytes = elem * c.B * c.C * c.H * c.H + 16 * c.B * c.R + 4 * out
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def roi_errors(got, want) -> dict:
    err = (got - want).abs()
    return {"max_abs_err": err.max().item(),
            "within": bool((err <= ROI_ATOL + ROI_RTOL * want.abs()).all()),
            "finite": _all_finite(got)}


def phase_kernel_det(device: str = "cuda", nms_cases=NMS_CASES,
                     roi_cases=ROI_CASES,
                     roi_grad_cases=ROI_GRAD_CASES) -> dict:
    """B4 and B5 against their plain versions on the same inputs, then
    ROIAlign's gradient (the kernel forward, `roi_align_grad` backward)
    against the plain gather form's autograd gradient; times on the card
    only."""
    import torch

    from cloudtik_tpu_torch.ops import detection as D

    on_card = device == "cuda"
    gen = torch.Generator(device=device).manual_seed(2)
    out = {"nms": {}, "roi_align": {}, "roi_align_grad": {}}
    for c in nms_cases:
        boxes, scores = make_nms_inputs(c, device)
        kw = {"iou_threshold": c.iou_threshold, "max_output": c.K}
        keep = D.nms_batched(boxes, scores, **kw)
        want = D.nms_reference_batched(boxes, scores, **kw)
        require(keep.shape == (c.B, c.K) and keep.dtype == torch.int32,
                f"nms {c.name}: keep {tuple(keep.shape)} {keep.dtype}")
        diff = (keep - want).abs().max().item()
        require(diff == 0, f"nms {c.name}: keep differs from the plain "
                           f"version in {int((keep != want).sum())} places")
        keep_np, scores_np = keep.cpu().numpy(), scores.cpu().numpy()
        check_nms_case(c, keep_np, scores_np)
        golden = golden_keep(c)
        require(golden is not None or not on_card,
                f"nms {c.name}: no JAX golden keep list for these inputs "
                f"in {GOLDEN_DIR}")
        if golden is not None:
            require(bool((keep_np == golden).all()),
                    f"nms {c.name}: keep differs from the JAX golden in "
                    f"{int((keep_np != golden).sum())} places")
        kept = int((keep >= 0).sum())
        bound_ms, bound_by, flops, nbytes = nms_bound(c, scores_np, keep_np)
        row = {"case": c.name, "B": c.B, "N": c.N, "K": c.K,
               "iou_threshold": c.iou_threshold, "kept": kept,
               "reached": nms_scan_work(scores_np, keep_np)[0],
               "max_abs_err": diff, "equal": True,
               "jax_golden_equal": golden is not None,
               "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
               "bytes": nbytes,
               "reference_steps_bound_ms": nms_steps_bound_ms(c, kept)}
        if on_card:
            row["kernel_ms"] = time_ms(lambda: D.nms_batched(
                boxes, scores, **kw))
            row["plain_ms"] = time_ms(lambda: D.nms_reference_batched(
                boxes, scores, **kw), iters=3, warmup=1)
        emit("kernel_det", kernel="nms", **row)
        out["nms"][c.name] = row
    for c in roi_cases:
        feats, rois = make_roi_inputs(c, gen, device)
        kw = {"pooled_size": c.P, "sampling_ratio": c.sampling,
              "spatial_scale": c.scale}
        D.LAST_ROI_ROUTE = None
        got = D.roi_align_batched(feats, rois, **kw)
        route = D.LAST_ROI_ROUTE       # None on the CPU: no kernel ran
        require(route == (c.route if on_card else None),
                f"roi_align {c.name}: took the {route} route, expected "
                f"{c.route}")
        want = D.roi_align_reference_batched(feats, rois, **kw)
        require(got.shape == (c.B, c.R, c.C, c.P, c.P)
                and got.dtype == torch.float32,
                f"roi_align {c.name}: output {tuple(got.shape)} {got.dtype}")
        errors = roi_errors(got, want)
        require(errors["finite"], f"roi_align {c.name}: non-finite output")
        require(errors["within"], f"roi_align {c.name}: differs from the "
                                  f"plain version {errors}")
        del got, want
        bound_ms, bound_by, flops, nbytes = roi_bound(c)
        row = {"case": c.name, "B": c.B, "R": c.R, "C": c.C, "H": c.H,
               "P": c.P, "sampling": c.sampling, "scale": c.scale,
               "dtype": c.dtype, "layout": c.layout, "rois": c.rois,
               "route": route, "max_abs_err": errors["max_abs_err"],
               "tolerance": {"atol": ROI_ATOL, "rtol": ROI_RTOL},
               "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
               "bytes": nbytes}
        if on_card:
            row["kernel_ms"] = time_ms(lambda: D.roi_align_batched(
                feats, rois, **kw))
            row["plain_ms"] = time_ms(lambda: D.roi_align_reference_batched(
                feats, rois, **kw), iters=3, warmup=1)
            torch.cuda.empty_cache()
        emit("kernel_det", kernel="roi_align", **row)
        out["roi_align"][c.name] = row
    for c in roi_grad_cases:
        out["roi_align_grad"][c.name] = roi_grad_case(c, gen, device)
    return out


def roi_grad_case(c: RoiCase, gen, device: str) -> dict:
    """ROIAlign at one training case: through `_RoIAlignFn` the forward
    (the kernel on the card) is held against the plain gather form's on
    the same (widened) map, and its gradient is exactly `roi_align_grad`'s,
    cast to the map's dtype; that f32 gradient is held against the plain
    form's autograd gradient, both within ROI_ATOL + ROI_RTOL |ref|.  The
    backward's bound is the forward's: it reads the output's gradient and
    writes the map's, the same bytes and taps."""
    import torch

    from cloudtik_tpu_torch.ops import detection as D

    on_card = device == "cuda"
    feats, rois = make_roi_inputs(c, gen, device)
    # the map as the detector holds it: an NHWC leaf, pooled through its
    # [B, C, H, W] view
    leaf = feats.permute(0, 2, 3, 1).detach().requires_grad_(True)
    fmap = leaf.permute(0, 3, 1, 2)
    kw = {"pooled_size": c.P, "sampling_ratio": c.sampling,
          "spatial_scale": c.scale}
    D.LAST_ROI_ROUTE = None
    pooled = D.roi_align_batched(fmap, rois, **kw)
    route = D.LAST_ROI_ROUTE
    require(route == (c.route if on_card else None),
            f"roi_align_grad {c.name}: took the {route} route, expected "
            f"{c.route}")
    widened = leaf.detach().float().requires_grad_(True)
    plain = D.roi_align_reference_batched(widened.permute(0, 3, 1, 2), rois,
                                          **kw)
    fwd_errors = roi_errors(pooled, plain)
    require(fwd_errors["finite"], f"roi_align_grad {c.name}: non-finite "
                                  "forward")
    require(fwd_errors["within"], f"roi_align_grad {c.name}: the forward "
                                  f"differs from the plain one {fwd_errors}")
    upstream = torch.randn(pooled.shape, generator=gen, device=device)
    (got,) = torch.autograd.grad(pooled, leaf, upstream)
    (want,) = torch.autograd.grad(plain, widened, upstream)
    del pooled, plain
    size = tuple(fmap.shape)
    grad32 = D.roi_align_grad(upstream, rois, size, **kw).permute(0, 2, 3, 1)
    require(got.dtype == leaf.dtype and torch.equal(got,
                                                    grad32.to(got.dtype)),
            f"roi_align_grad {c.name}: the Function's gradient is not "
            "roi_align_grad's")
    errors = roi_errors(grad32, want)
    require(errors["finite"], f"roi_align_grad {c.name}: non-finite")
    require(errors["within"], f"roi_align_grad {c.name}: differs from the "
                              f"plain gradient {errors}")
    del got, grad32, want
    bound_ms, bound_by, flops, nbytes = roi_bound(c)
    row = {"case": c.name, "B": c.B, "R": c.R, "C": c.C, "H": c.H,
           "P": c.P, "sampling": c.sampling, "dtype": c.dtype,
           "route": route, "forward_max_abs_err": fwd_errors["max_abs_err"],
           "max_abs_err": errors["max_abs_err"],
           "tolerance": {"atol": ROI_ATOL, "rtol": ROI_RTOL},
           "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
           "bytes": nbytes}
    if on_card:
        detached = fmap.detach()
        row["forward_kernel_ms"] = time_ms(lambda: D.roi_align_batched(
            detached, rois, **kw))
        row["backward_ms"] = time_ms(lambda: D.roi_align_grad(
            upstream, rois, size, **kw))

        def plain():
            x = detached.float().requires_grad_(True)
            return torch.autograd.grad(D.roi_align_reference_batched(
                x, rois, **kw), x, upstream)

        row["plain_forward_backward_ms"] = time_ms(plain, iters=3, warmup=1)
        torch.cuda.empty_cache()
    emit("kernel_det", kernel="roi_align_grad", **row)
    return row


# ------------------------------------------------------------------ detect --

def _det_launch_counts() -> dict:
    from cloudtik_tpu_torch.ops import detection as D

    return {"nms": D.LAUNCHES_NMS, "roi_align": D.LAUNCHES_ROI_ALIGN}


def _zero_det_launch_counts() -> None:
    from cloudtik_tpu_torch.ops import detection as D

    D.LAUNCHES_NMS = D.LAUNCHES_ROI_ALIGN = 0


def _timed_call(fn, on_card: bool):
    """(result, ms) of one call: CUDA events on the card, else the host
    clock."""
    import torch

    if not on_card:
        t0 = time.perf_counter()
        result = fn()
        return result, (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    end.synchronize()
    return result, start.elapsed_time(end)


def phase_detect(kind: str, name: str, B: int = 8, device: str = "cuda",
                 warmup: int = 1, iters: int = 5, **overrides) -> dict:
    """`detect` of a repo preset at full width (bf16 compute, f32 params,
    random weights from seed 0), with `overrides` of its config (such as
    `image_size`): `warmup` calls, then the detection counts zeroed,
    `iters` measured calls, the counts read.  Then the last call's outputs
    are checked, and its NMS and ROIAlign inputs are held against the plain
    versions (launches made for that come after the counts)."""
    import torch

    from cloudtik_tpu_torch.models import maskrcnn as MR
    from cloudtik_tpu_torch.models import ssd as SD
    from cloudtik_tpu_torch.ops import detection as D

    M = {"maskrcnn": MR, "ssd": SD}[kind]
    cfg = M.config(name, **overrides)
    on_card = device == "cuda"
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(gen, cfg, device)
    S = cfg.image_size
    images = torch.randn((B, S, S, 3), generator=gen, device=device)

    def call():
        return M.detect(params, images, cfg, device=device)

    for _ in range(warmup):
        call()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # ---- the detection path: counts zeroed just before, read just after --
    _zero_det_launch_counts()
    ms = []
    for _ in range(iters):
        out, t = _timed_call(call, on_card)
        ms.append(t)
    launches = _det_launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None

    K = out["keep"].shape[1]
    valid = out["keep"] >= 0
    labels = out["labels"]
    require(out["boxes"].shape == (B, K, 4) and out["scores"].shape == (B, K),
            f"{name}: output shapes")
    for key in ("boxes", "scores", "nms_boxes", "nms_scores"):
        require(_all_finite(out[key]), f"{name}: non-finite {key}")
    require(bool(((labels >= 1) & (labels < cfg.num_classes))[valid].all())
            and bool((labels[~valid] == 0).all()),
            f"{name}: labels outside [1, {cfg.num_classes})")
    boxes = out["boxes"][valid]
    require(bool((boxes[:, 2:] >= boxes[:, :2]).all()),
            f"{name}: a kept box with x2 < x1 or y2 < y1")
    want_keep = D.nms_reference_batched(
        out["nms_boxes"], out["nms_scores"], iou_threshold=0.5,
        max_output=K)
    require(bool((out["keep"] == want_keep).all()),
            f"{name}: NMS keep differs from the plain version on the "
            "call's own boxes and scores")
    result = {"model": name, "batch": B, "image_size": S,
              "nms_boxes_per_image": out["nms_scores"].shape[1],
              "dtype": "bfloat16", "warmup_calls": warmup,
              "measured_calls": iters, "ms_per_call": ms,
              "mean_ms": sum(ms) / len(ms),
              "images_per_s": B / (sum(ms) / len(ms) / 1e3),
              "peak_mem_gb": peak, "launches": launches,
              "kept_per_image": valid.sum(dim=1).tolist(),
              "nms_equal": True}
    if kind == "maskrcnn":
        # Mask R-CNN clips its boxes; SSD's decode is unclipped, as in JAX
        require(bool(((boxes >= 0) & (boxes <= 1)).all()),
                f"{name}: boxes outside [0, 1]")
        require(_all_finite(out["mask_logits"]), f"{name}: mask logits")
        feat = out["feature"].permute(0, 3, 1, 2)
        rois = out["proposals"] * out["feature"].shape[1]
        errs, routes = {}, {}
        for P in (cfg.roi_pool, cfg.mask_pool):
            kw = {"pooled_size": P, "sampling_ratio": 1,
                  "spatial_scale": 1.0}
            D.LAST_ROI_ROUTE = None
            got = D.roi_align_batched(feat, rois, **kw)
            routes[f"pooled_{P}"] = D.LAST_ROI_ROUTE
            e = roi_errors(got, D.roi_align_reference_batched(
                feat, rois, **kw))
            require(e["within"] and e["finite"],
                    f"{name}: pooled {P}x{P} differ from the plain "
                    f"ROIAlign {e}")
            errs[f"pooled_{P}"] = e["max_abs_err"]
        result["roi_align_max_abs_err"] = errs
        # the same map and rois as the path's two launches
        result["roi_align_route"] = routes
        require(all(r == ("vector" if on_card else None)
                    for r in routes.values()),
                f"{name}: ROIAlign took the routes {routes}, expected the "
                "vector route on the card")
    emit("detect", **result)
    del params, out
    if on_card:
        torch.cuda.empty_cache()
    return result


# ---------------------------------------------------- vision training --

@dataclasses.dataclass(frozen=True)
class RecipeLoad:
    """A recipe training phase: `recipes.<recipe>.build` plus `argv` (the
    per-card batch of the JAX recipe's launch line), the recipe's AdamW
    with `optimizer`'s overrides (by default no warmup: the recipe's
    100-step warmup gives a learning rate of ~0 to a run of a few steps),
    `warmup` then `steps` measured steps on one repeated batch."""
    recipe: str
    argv: tuple = ()
    warmup: int = 2
    steps: int = 5
    optimizer: tuple = (("warmup_steps", 0),)


# --batch 1024 --data 8, --batch 256 --data 8 and --batch 32 --data 8: the
# per-card batches of the JAX recipes' launch lines
RESNET_TRAIN_LOAD = RecipeLoad("resnet50_imagenet", ("--batch", "128"))
SSD_TRAIN_LOAD = RecipeLoad("ssd_coco", ("--batch", "32"))
# Mask R-CNN keeps the recipe's 100-step warmup: at 3e-4 from the first
# step its heads diverge (the loss went 17.3 -> 36.1 -> 87.2 on the card,
# fc1's fan-in is 50,176), while under the warmup it falls
MASKRCNN_TRAIN_LOAD = RecipeLoad("maskrcnn_coco", ("--batch", "4"),
                                 optimizer=())
# the CPU rehearsals at `tiny`
RESNET_TRAIN_REHEARSAL = RecipeLoad(
    "resnet50_imagenet", ("--model", "tiny", "--image-size", "32",
                          "--batch", "4"), warmup=1, steps=2)
SSD_TRAIN_REHEARSAL = RecipeLoad(
    "ssd_coco", ("--model", "tiny", "--image-size", "64", "--batch", "2"),
    warmup=1, steps=2)
MASKRCNN_TRAIN_REHEARSAL = RecipeLoad(
    "maskrcnn_coco", ("--model", "tiny", "--image-size", "64", "--batch",
                      "2"), warmup=1, steps=2)
# the detection kernels' launches per Mask R-CNN train step: its two
# poolings; no NMS (training proposes by top-K)
MASKRCNN_STEP_LAUNCHES = {"nms": 0, "roi_align": 2}


def _recipe_train(name: str, load: RecipeLoad, device: str,
                  nvidia_smi: str = None):
    """The recipe's trainer on one repeated batch of its data: the
    measured steps with every kernel's launch count zeroed just before and
    read just after, the loss falling.  Returns (result, trainer, host
    batch, cfg, parsed args)."""
    import importlib

    import torch

    from cloudtik_tpu_torch.train.optim import OptimizerConfig

    on_card = device == "cuda"
    _collect(on_card)
    recipe = importlib.import_module(
        f"cloudtik_tpu_torch.recipes.{load.recipe}")
    args = recipe.parser().parse_args(
        ["--device", device, "--log-every", "1", *load.argv])
    trainer, data, cfg = recipe.build(args,
                                      OptimizerConfig(**dict(load.optimizer)))
    trainer.init_state(torch.Generator(device=device).manual_seed(0))
    batch = next(data)
    train = _train_measured(trainer, itertools.repeat(batch), load.warmup,
                            load.steps, on_card, detection=True)
    entry = train.pop("last")
    opt = trainer.config.optimizer
    out = {"model": args.model, "nvidia_smi": nvidia_smi,
           "recipe": load.recipe, "batch": args.batch,
           "dtype": str(cfg.dtype).replace("torch.", ""),
           "optimizer": {"name": opt.name, "lr": opt.learning_rate,
                         "warmup_steps": opt.warmup_steps,
                         "weight_decay": opt.weight_decay},
           "flops_per_item": trainer.spec.flops_per_token, **train,
           "metrics": {k: v for k, v in entry.items()
                       if k not in ("step", "tokens_per_sec", "mfu")}}
    out["history"] = train.pop("history")
    require(math.isfinite(entry["loss"]), f"{name}: loss {entry['loss']}")
    _check_losses(name, out["losses"])
    return out, trainer, batch, cfg, args


def _vision_train(name: str, load: RecipeLoad, device: str,
                  nvidia_smi: str = None):
    """`_recipe_train` of a vision recipe, its throughput in images.
    Returns (result, trainer, host batch, cfg)."""
    out, trainer, batch, cfg, _ = _recipe_train(name, load, device,
                                                nvidia_smi)
    out["image_size"] = cfg.image_size
    out["flops_per_image"] = out.pop("flops_per_item")
    out["images_per_s"] = out.pop("tokens_per_s")
    return out, trainer, batch, cfg


def _require_no_launches(name: str, out: dict, allowed=None) -> None:
    """Per step: no B1-B5 launch but those `allowed` ({kernel: n})."""
    want = {k: 0 for k in out["launches_per_step"]}
    want.update(allowed or {})
    require(out["launches_per_step"] == want,
            f"{name} step launches {out['launches_per_step']}, expected "
            f"{want}")


def phase_resnet_train(load: RecipeLoad = RESNET_TRAIN_LOAD,
                       device: str = "cuda", nvidia_smi: str = None) -> dict:
    """ResNet-50 at 224 through `recipes.resnet50_imagenet.build`."""
    out, trainer, _, _ = _vision_train("resnet_train", load, device,
                                       nvidia_smi)
    emit("resnet_train", **out)
    _require_no_launches("resnet_train", out)
    del trainer
    _collect(device == "cuda")
    return out


def phase_ssd_train(load: RecipeLoad = SSD_TRAIN_LOAD, device: str = "cuda",
                    nvidia_smi: str = None) -> dict:
    """SSD-ResNet34 at 300 through `recipes.ssd_coco.build`; every image
    of the batch has a positive anchor."""
    import torch

    from cloudtik_tpu_torch.models import ssd as SD

    out, trainer, batch, cfg = _vision_train("ssd_train", load, device,
                                             nvidia_smi)
    with torch.no_grad():
        labels, _ = SD.match_anchors(
            torch.as_tensor(batch["gt_boxes"], device=device),
            torch.as_tensor(batch["gt_labels"], device=device),
            SD.anchors_on(cfg, torch.device(device)), cfg)
    out["num_pos_per_image"] = (labels > 0).sum(dim=1).tolist()
    emit("ssd_train", **out)
    require(min(out["num_pos_per_image"]) >= 1,
            f"ssd_train: an image without a positive anchor "
            f"{out['num_pos_per_image']}")
    _require_no_launches("ssd_train", out)
    del trainer
    _collect(device == "cuda")
    return out


def _named_leaves(tree, prefix: str = "") -> list:
    """[(dotted name, tensor)] in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _named_leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _named_leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


# The backbone's gradient with the ROI losses must differ from its gradient
# from the RPN alone by at least this share of its norm: a ROIAlign without
# a gradient leaves them equal but for the order of cuDNN's sums (~1e-6).
BACKBONE_FROM_HEADS_MIN = 1e-3
# One Mask R-CNN step's gradients, the kernel's ROIAlign against the plain
# one, per leaf in relative L2.  In f32 compute only the order of the sums
# differs (1.5e-5 read on the card); a missing or wrong ROIAlign gradient
# moves the backbone's leaves by a share of ~0.8.
MASKRCNN_F32_GRAD_REL_L2 = 1e-3
# In the bf16 training configuration the pooled maps round to bf16, so the
# ~1e-6 between the kernel's sums and the gather form's flips roundings
# that the BN layers' backward amplifies toward the stem: the median leaf
# is held to train_grads' limit and the largest to about three times the
# largest read on the card (0.086), beside the same step's spread between
# two plain ROIAlign runs whose pooled maps differ by POOLED_PERTURBATION
# of their values (the noise floor, reported).
MASKRCNN_BF16_GRAD_REL_L2_MEDIAN = GRADS_REL_L2
MASKRCNN_BF16_GRAD_REL_L2_MAX = 0.25
POOLED_PERTURBATION = 1e-6


def phase_maskrcnn_train(load: RecipeLoad = MASKRCNN_TRAIN_LOAD,
                         device: str = "cuda",
                         nvidia_smi: str = None) -> dict:
    """Mask R-CNN at 512 with masks through `recipes.maskrcnn_coco.build`:
    exactly 2 ROIAlign launches a step on the vector route; then one step's
    gradients at full width, every leaf with the kernel's `_RoIAlignFn`
    against the same step with the plain ROIAlign forced: in f32 compute
    within MASKRCNN_F32_GRAD_REL_L2, in the bf16 training configuration
    the median leaf and the largest within their limits, beside a rerun of
    the kernel step and a plain step whose pooled maps move by
    POOLED_PERTURBATION (reported); and the backbone's gradient with the
    ROI losses against the RPN's alone."""
    import torch

    from cloudtik_tpu_torch.models import maskrcnn as MR
    from cloudtik_tpu_torch.ops import detection as D

    on_card = device == "cuda"
    out, trainer, batch, cfg = _vision_train("maskrcnn_train", load, device,
                                             nvidia_smi)
    out["mask_size"] = batch["gt_masks"].shape[-1]
    params = trainer.params
    named = _named_leaves(params)
    names = [n for n, _ in named]
    leaves = [t for _, t in named]
    dbatch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}

    pooled_gap = {"max_abs": 0.0, "max_ref": 0.0}

    def perturbed(*args, **kw):
        """The plain ROIAlign, every output moved by POOLED_PERTURBATION
        of itself (a fixed draw)."""
        out = D.roi_align_reference_batched(*args, **kw)
        noise = torch.randn(out.shape, device=out.device,
                            generator=torch.Generator(
                                device=out.device).manual_seed(3))
        return out * (1.0 + POOLED_PERTURBATION * noise)

    def probed(*args, **kw):
        """The kernel's ROIAlign, its output's distance from the plain
        one's on the same inputs recorded on the side."""
        out = D.roi_align_batched(*args, **kw)
        with torch.no_grad():
            want = D.roi_align_reference_batched(*args, **kw)
            pooled_gap["max_abs"] = max(pooled_gap["max_abs"],
                                        (out - want).abs().max().item())
            pooled_gap["max_ref"] = max(pooled_gap["max_ref"],
                                        want.abs().max().item())
        return out

    def step_grads(step_cfg, pool=None):
        """One step's gradient of every leaf, with `pool` forced into
        `roi_heads` in place of the kernel's ROIAlign when given."""
        real = MR.roi_align_batched
        if pool is not None:
            MR.roi_align_batched = pool
        try:
            loss = MR.loss_fn(params, dbatch, step_cfg)[0]
            return torch.autograd.grad(loss, leaves, allow_unused=True,
                                       materialize_grads=True)
        finally:
            MR.roi_align_batched = real

    def rel_by_leaf(got, want):
        rel = {}
        for n, a, b in zip(names, got, want):
            norm = b.float().norm()
            if norm == 0:
                require(not bool(a.any()), f"maskrcnn_train: {n} has a "
                        "gradient on one path only")
                continue
            rel[n] = ((a.float() - b.float()).norm() / norm).item()
        return rel

    def median(rel):
        return sorted(rel.values())[len(rel) // 2]

    # the training configuration (bf16 compute, the vector route): the
    # step's launches; the plain ROIAlign's step against it; and, as its
    # noise floor, a rerun of it and a plain step against a plain step
    # whose pooled maps moved by POOLED_PERTURBATION
    _zero_det_launch_counts()
    D.LAST_ROI_ROUTE = None
    kernel_grads = step_grads(cfg)
    step_launches = _det_launch_counts()
    route = D.LAST_ROI_ROUTE
    bf16_rerun = rel_by_leaf(step_grads(cfg, probed), kernel_grads)
    plain_grads = step_grads(cfg, D.roi_align_reference_batched)
    bf16_plain = rel_by_leaf(plain_grads, kernel_grads)
    bf16_witness = rel_by_leaf(step_grads(cfg, perturbed), plain_grads)
    del plain_grads
    # in f32 compute (the strided route): only the order of the sums
    # differs between the two paths
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    rel = rel_by_leaf(step_grads(cfg32),
                      step_grads(cfg32, D.roi_align_reference_batched))
    zero = len(names) - len(rel)
    worst = max(rel, key=rel.get)
    bf16_worst = max(bf16_plain, key=bf16_plain.get)

    # the backbone's gradient from the heads: with the ROI losses against
    # the RPN's alone
    feat = MR.backbone_feature(params, dbatch["images"], cfg)
    obj, deltas = MR.rpn_forward(params, feat, cfg)
    rpn = sum(MR.rpn_losses(obj, deltas, dbatch["gt_boxes"].float(),
                            dbatch["gt_labels"].long(),
                            MR.anchors_on(cfg, obj.device), cfg))
    backbone = [i for i, n in enumerate(names) if n.startswith("backbone.")]
    rpn_grads = torch.autograd.grad(rpn, [leaves[i] for i in backbone],
                                    allow_unused=True,
                                    materialize_grads=True)
    moved, d2, n2 = {}, 0.0, 0.0
    for i, g_rpn in zip(backbone, rpn_grads):
        g = kernel_grads[i].float()
        if g.norm() == 0:
            continue      # stages past the C4 feature
        d = (g - g_rpn.float()).norm()
        moved[names[i]] = (d / g.norm()).item()
        d2 += d.item() ** 2
        n2 += g.norm().item() ** 2
    share = math.sqrt(d2 / n2)
    out.update(
        roi_route=route, grad_step_launches=step_launches,
        grad_rel_l2_kernel_vs_plain_max={worst: rel[worst]},
        grad_rel_l2_kernel_vs_plain=rel, zero_grad_leaves=zero,
        tolerance_rel_l2=MASKRCNN_F32_GRAD_REL_L2,
        bf16_grad_rel_l2_rerun_max=max(bf16_rerun.values()),
        bf16_grad_rel_l2_kernel_vs_plain_max={
            bf16_worst: bf16_plain[bf16_worst]},
        bf16_grad_rel_l2_kernel_vs_plain_median=median(bf16_plain),
        bf16_tolerance_rel_l2={"median": MASKRCNN_BF16_GRAD_REL_L2_MEDIAN,
                               "max": MASKRCNN_BF16_GRAD_REL_L2_MAX},
        bf16_pooled_kernel_vs_plain_max_abs=pooled_gap["max_abs"],
        bf16_pooled_max_abs=pooled_gap["max_ref"],
        bf16_witness_perturbation=POOLED_PERTURBATION,
        bf16_witness_grad_rel_l2_max=max(bf16_witness.values()),
        bf16_witness_grad_rel_l2_median=median(bf16_witness),
        backbone_grad_from_heads_share=share,
        backbone_grad_from_heads_min_leaf=min(moved.values()),
        backbone_grad_from_heads_limit=BACKBONE_FROM_HEADS_MIN)
    emit("maskrcnn_train", **out)
    want = MASKRCNN_STEP_LAUNCHES if on_card else {}
    _require_no_launches("maskrcnn_train", out, want)
    require(step_launches == {"nms": 0, "roi_align": 0, **want},
            f"maskrcnn_train: the gradient step launched {step_launches}")
    require(route == ("vector" if on_card else None),
            f"maskrcnn_train: ROIAlign took the {route} route")
    require(all(_all_finite(g) for g in kernel_grads),
            "maskrcnn_train: non-finite gradients")
    require(rel[worst] <= MASKRCNN_F32_GRAD_REL_L2,
            f"maskrcnn_train: {worst}'s f32 gradient with the ROIAlign "
            f"kernel differs from the plain one's by {rel[worst]}")
    require(median(bf16_plain) <= MASKRCNN_BF16_GRAD_REL_L2_MEDIAN
            and bf16_plain[bf16_worst] <= MASKRCNN_BF16_GRAD_REL_L2_MAX,
            f"maskrcnn_train: the bf16 step's gradients with the ROIAlign "
            f"kernel differ from the plain one's by {median(bf16_plain)} "
            f"(median leaf), {bf16_plain[bf16_worst]} ({bf16_worst})")
    require(moved and min(moved.values()) > 0
            and share >= BACKBONE_FROM_HEADS_MIN,
            f"maskrcnn_train: the ROI losses move the backbone's gradient "
            f"by {share} (limit {BACKBONE_FROM_HEADS_MIN}): {moved}")
    del trainer, params, leaves, kernel_grads, dbatch, feat, obj, deltas
    _collect(on_card)
    return out


# -------------------------------------------------------------- loaders --

@dataclasses.dataclass(frozen=True)
class LoadersLoad:
    """The loaders phase: `model` at full width and `n_layers` layers (a
    depth cut for the script's time), B x S, `steps` shards of one batch
    each published `delay_s` apart while the trainer streams them."""
    model: str = "tpu_1b"
    n_layers: int = 2
    batch: int = 8
    seq: int = 2048
    steps: int = 3
    delay_s: float = 0.2


LOADERS_LOAD = LoadersLoad()
LOADERS_REHEARSAL = LoadersLoad(model="tiny", batch=2, seq=32,
                                delay_s=0.05)
FLASH_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                 "flash_bwd_dkv_kernel")


def phase_loaders(load: LoadersLoad = LOADERS_LOAD, device: str = "cuda",
                  nvidia_smi: str = None) -> dict:
    """A writer thread publishes token shards (`export_token_shard`, then
    `finish_export`) while `streaming_shard_batches` feeds
    `Trainer.fit(profile_dir=...)`: every batch the trainer took equals the
    tokens published, reshaped; the marker ends the stream; the trace
    exists and (on the card) names the three flash kernels; the same
    corpus through `tokenized_file_batches(repeat=False)` gives the
    batches it holds.  Launch counts are zeroed just before the fit and
    read just after."""
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.train import data as TD
    from cloudtik_tpu_torch.train.trainer import (
        Trainer, TrainerConfig, transformer_spec)

    on_card = device == "cuda"
    L = load
    _collect(on_card)
    cfg = T.config(L.model, n_layers=L.n_layers, max_seq_len=L.seq)
    rng = np.random.default_rng(7)
    shards = [rng.integers(0, cfg.vocab_size, L.batch * (L.seq + 1),
                           dtype=np.int32) for _ in range(L.steps)]
    root = tempfile.mkdtemp(prefix="tik-loaders-")
    export_dir = os.path.join(root, "export")
    profile_dir = os.path.join(root, "profile")
    published = []

    def write():
        for i, tokens in enumerate(shards):
            time.sleep(L.delay_s)
            TD.export_token_shard(export_dir, i, tokens)
            published.append(time.monotonic())
        TD.finish_export(export_dir)

    stream = TD.streaming_shard_batches(export_dir, L.batch, L.seq,
                                        poll_s=0.05, timeout_s=120)
    taken = []

    def recorded():
        for b in stream:
            taken.append(b)
            yield b

    writer = threading.Thread(target=write, daemon=True,
                              name="tik-loaders-writer")
    try:
        trainer = Trainer(transformer_spec(cfg), TrainerConfig(
            global_batch_size=L.batch, seq_len=L.seq, log_every=L.steps),
            device=device)
        trainer.init_state(torch.Generator(device=device).manual_seed(0))
        writer.start()
        t_start = time.monotonic()
        _zero_launch_counts()
        t0 = time.perf_counter()
        entry = trainer.fit(recorded(), L.steps,
                            profile_dir=profile_dir)["history"][-1]
        wall_s = time.perf_counter() - t0
        launches = _launch_counts()
        writer.join(timeout=60)
        require(not writer.is_alive(), "loaders: the writer never finished")
        rest = list(stream)
        rows = np.concatenate(shards).reshape(-1, L.seq + 1)
        equal = [np.array_equal(b["tokens"], rows[i * L.batch:(i + 1)
                                                  * L.batch, :-1])
                 and np.array_equal(b["labels"], rows[i * L.batch:(i + 1)
                                                      * L.batch, 1:])
                 for i, b in enumerate(taken)]
        trace_path = os.path.join(profile_dir, "trace.json")
        require(os.path.exists(trace_path), "loaders: no trace written")
        with open(trace_path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        named = {k: any(k in n for n in names) for k in FLASH_KERNELS}
        corpus = os.path.join(root, "corpus.npy")
        np.save(corpus, np.concatenate(shards))
        file_batches = list(TD.tokenized_file_batches(
            corpus, L.batch, L.seq, repeat=False))
        out = {"model": L.model, "n_layers": L.n_layers,
               "nvidia_smi": nvidia_smi, "batch": L.batch, "seq": L.seq,
               "shards": len(shards), "steps": L.steps,
               "batches_taken": len(taken), "batches_after_marker": len(rest),
               "all_equal": all(equal) and len(equal) == L.steps,
               "started_before_last_shard": t_start < published[-1],
               "ms_per_step_profiled": wall_s / L.steps * 1e3,
               "loss": entry["loss"], "launches": launches,
               "launches_per_step": {k: n / L.steps
                                     for k, n in launches.items()},
               "trace_bytes": os.path.getsize(trace_path),
               "trace_names_kernels": named,
               "file_batches": len(file_batches)}
    finally:
        stream.close()
        shutil.rmtree(root, ignore_errors=True)
    emit("loaders", **out)
    require(out["all_equal"], f"loaders: a batch differs from the tokens "
                              f"published: {equal}")
    require(not rest, f"loaders: {len(rest)} batches after the marker")
    require(math.isfinite(entry["loss"]), f"loaders: loss {entry['loss']}")
    require(all(named.values()) or not on_card,
            f"loaders: the trace does not name the flash kernels {named}")
    require(out["file_batches"] == L.steps,
            f"loaders: tokenized_file_batches gave {out['file_batches']} "
            f"batches of the corpus, expected {L.steps}")
    n = L.n_layers if on_card else 0
    require(out["launches_per_step"] == {k: n for k in launches},
            f"loaders step launches {out['launches_per_step']}, expected "
            f"{n} of each flash kernel")
    del trainer
    _collect(on_card)
    return out


# ------------------------------------------------------------ model zoo --

# sdxl_mini at the recipe's --batch default (the JAX recipe gives no launch
# line); criteo_terabyte at B=8,192 (at the recipe's default of 8 a step
# would be the optimizer's 335M-parameter update alone); RNN-T at the JAX
# launch line's --batch 64 --data 8, 8 utterances a card of 256 frames and
# 64 labels; GraphSAGE on the recipe's 4,096-node blocks, supervised, then
# link prediction for 2 steps
DIFFUSION_TRAIN_LOAD = RecipeLoad("sdxl_fsdp", ("--batch", "8"))
DLRM_TRAIN_LOAD = RecipeLoad("dlrm_criteo", ("--batch", "8192"))
RNNT_TRAIN_LOAD = RecipeLoad("rnnt_speech", ("--batch", "8"))
GRAPHSAGE_TRAIN_LOAD = RecipeLoad("graphsage_nodes")
GRAPHSAGE_LINK_LOAD = RecipeLoad("graphsage_nodes",
                                 ("--objective", "link_pred"), warmup=1,
                                 steps=1)
# the CPU rehearsals at `tiny`
DIFFUSION_TRAIN_REHEARSAL = RecipeLoad(
    "sdxl_fsdp", ("--model", "tiny", "--batch", "2"), warmup=1, steps=2)
DLRM_TRAIN_REHEARSAL = RecipeLoad(
    "dlrm_criteo", ("--model", "tiny", "--batch", "64"), warmup=1, steps=2)
RNNT_TRAIN_REHEARSAL = RecipeLoad(
    "rnnt_speech", ("--model", "tiny", "--batch", "2", "--max-frames", "16",
                    "--max-labels", "4"), warmup=1, steps=2)
GRAPHSAGE_TRAIN_REHEARSAL = RecipeLoad(
    "graphsage_nodes", ("--model", "tiny", "--nodes", "64"), warmup=1,
    steps=2)
GRAPHSAGE_LINK_REHEARSAL = RecipeLoad(
    "graphsage_nodes", ("--model", "tiny", "--nodes", "64", "--objective",
                        "link_pred"), warmup=1, steps=1)


@dataclasses.dataclass(frozen=True)
class ZooCheck:
    """A cross-device check: `model` with `overrides` (a depth or size
    cut, never a width cut) in f32, `batch` examples (for RNN-T `frames`
    frames and `labels` labels), one step's loss and gradients on the card
    against the CPU's from the same params."""
    model: str
    overrides: tuple = ()
    batch: int = 2
    frames: int = 0
    labels: int = 0


DIFFUSION_CHECK = ZooCheck("sdxl_mini", (("blocks_per_stage", 1),
                                         ("image_size", 16)))
DLRM_CHECK = ZooCheck("criteo_terabyte", (("num_tables", 2),), batch=8192)
RNNT_CHECK = ZooCheck("rnnt", (("enc_layers_pre", 1), ("enc_layers_post", 1)),
                      frames=64, labels=16)
GRAPHSAGE_CHECK = ZooCheck("graphsage", batch=4096)
DIFFUSION_CHECK_REHEARSAL = ZooCheck("tiny")
DLRM_CHECK_REHEARSAL = ZooCheck("tiny", (("num_tables", 2),), batch=64)
RNNT_CHECK_REHEARSAL = ZooCheck("tiny", frames=16, labels=4)
GRAPHSAGE_CHECK_REHEARSAL = ZooCheck("tiny", batch=64)

# One step's gradients on the card against the CPU's from the same params,
# f32 compute with TF32 off, per leaf in relative L2: only the order of the
# sums differs (cuDNN's, cuBLAS's and the scatter-adds' against the CPU's).
ZOO_GRAD_REL_L2 = 1e-3
# The card's transducer loss against the float64 oracle on the same
# log-probs, relative: the f32 lattice rounds each LSE.
TRANSDUCER_REL = 1e-4


def _zoo_launches() -> dict:
    return {**_launch_counts(), **_det_launch_counts()}


def _zero_zoo_launches() -> None:
    _zero_launch_counts()
    _zero_det_launch_counts()


def _cross_device_grads(name: str, loss_fn, params, batch: dict,
                        device: str) -> dict:
    """One loss and every gradient leaf of `loss_fn(params, batch)` on
    `device` and then on the CPU, from the same params (a CPU tree) and
    numpy batch, with TF32 off.  Returns the losses and each leaf's
    relative L2 distance (a leaf with no gradient on either side must have
    none on the other)."""
    import torch

    from cloudtik_tpu_torch.tree import tree_map

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = {}
    try:
        for i, dev in enumerate((device, "cpu")):
            p = tree_map(lambda t: t.detach().to(dev).requires_grad_(True),
                         params)
            b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            named = _named_leaves(p)
            loss, _ = loss_fn(p, b)
            grads = torch.autograd.grad(loss, [t for _, t in named],
                                        allow_unused=True,
                                        materialize_grads=True)
            runs[i] = (loss.item(), [g.detach().cpu().double()
                                     for g in grads])
            del p, b, loss, grads
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    rel = {}
    for (n, _), a, b in zip(named, runs[0][1], runs[1][1]):
        norm = b.norm()
        if norm == 0:
            require(not bool(a.any()), f"{name}: {n} has a gradient on one "
                    "device only")
            continue
        rel[n] = ((a - b).norm() / norm).item()
    worst = max(rel, key=rel.get)
    return {"loss_card": runs[0][0], "loss_cpu": runs[1][0],
            "grad_rel_l2_max": {worst: rel[worst]},
            "grad_rel_l2_median": sorted(rel.values())[len(rel) // 2],
            "grad_leaves": len(rel),
            "zero_grad_leaves": len(named) - len(rel),
            "tolerance_rel_l2": ZOO_GRAD_REL_L2}


def _require_grads(name: str, check: dict) -> None:
    (leaf, worst), = check["grad_rel_l2_max"].items()
    require(worst <= ZOO_GRAD_REL_L2,
            f"{name}: {leaf}'s gradient on the card differs from the CPU's "
            f"by {worst} (limit {ZOO_GRAD_REL_L2})")
    require(abs(check["loss_card"] - check["loss_cpu"])
            <= ZOO_GRAD_REL_L2 * abs(check["loss_cpu"]),
            f"{name}: loss {check['loss_card']} on the card, "
            f"{check['loss_cpu']} on the CPU")


def _zoo_phase_end(name: str, out: dict, trainer, on_card: bool) -> None:
    """Emit the phase's line, hold it to no B1-B5 launch, free it."""
    emit(name, **out)
    _require_no_launches(name, out)
    del trainer
    _collect(on_card)


def phase_diffusion_train(load: RecipeLoad = DIFFUSION_TRAIN_LOAD,
                          device: str = "cuda",
                          nvidia_smi: str = None) -> dict:
    """sdxl_mini through `recipes.sdxl_fsdp.build`: f32 params, bf16
    compute, AdamW; no attention layer takes the flash kernel (head dims
    80 and 160), so no B1-B5 launch."""
    from cloudtik_tpu_torch.tree import tree_leaves

    out, trainer, _, cfg, _ = _recipe_train("diffusion_train", load, device,
                                            nvidia_smi)
    n_stages = len(cfg.width_mults)
    out.update(image_size=cfg.image_size,
               images_per_s=out.pop("tokens_per_s"),
               num_params=sum(p.numel() for p in tree_leaves(trainer.params)),
               attention_head_dims=sorted(
                   {cfg.stage_width(s) // cfg.n_heads
                    for s in (*cfg.attn_stages, n_stages - 1)}))
    _zoo_phase_end("diffusion_train", out, trainer, device == "cuda")
    return out


def phase_diffusion_grads(check: ZooCheck = DIFFUSION_CHECK,
                          device: str = "cuda") -> dict:
    """sdxl_mini's widths cut to one block a stage at 16x16 latents, f32:
    one step's gradients on the card against the CPU's."""
    import torch

    from cloudtik_tpu_torch.models import diffusion as U
    from cloudtik_tpu_torch.train.data import synthetic_diffusion_batches

    cfg = U.config(check.model, dtype=torch.float32, **dict(check.overrides))
    params = U.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = next(synthetic_diffusion_batches(check.batch, cfg.image_size,
                                             cfg.in_channels, seed=1))
    _zero_zoo_launches()
    grads = _cross_device_grads(
        "diffusion_grads", lambda p, b: U.loss_fn(p, b, cfg), params, batch,
        device)
    out = {"model": check.model, "overrides": dict(check.overrides),
           "batch": check.batch, "widths": [cfg.stage_width(s) for s in
                                             range(len(cfg.width_mults))],
           **grads, "launches": _zoo_launches()}
    emit("diffusion_grads", **out)
    _require_grads("diffusion_grads", out)
    require(not any(out["launches"].values()),
            f"diffusion_grads launched {out['launches']}")
    _collect(device == "cuda")
    return out


def phase_dlrm_train(load: RecipeLoad = DLRM_TRAIN_LOAD,
                     check: ZooCheck = DLRM_CHECK, device: str = "cuda",
                     nvidia_smi: str = None) -> dict:
    """criteo_terabyte through `recipes.dlrm_criteo.build` (the whole
    table stack on the card, a dense table gradient, AdamW); then the
    2-table cut in f32, card against CPU."""
    import torch

    from cloudtik_tpu_torch.models import dlrm as D
    from cloudtik_tpu_torch.train.data import synthetic_dlrm_batches

    out, trainer, _, cfg, _ = _recipe_train("dlrm_train", load, device,
                                            nvidia_smi)
    out.update(examples_per_s=out.pop("tokens_per_s"),
               num_params=cfg.num_params(),
               table_params=cfg.num_tables * cfg.rows_per_table
               * cfg.embed_dim)
    _zoo_phase_end("dlrm_train", out, trainer, device == "cuda")

    ccfg = D.config(check.model, dtype=torch.float32,
                    **dict(check.overrides))
    params = D.init_params(torch.Generator().manual_seed(0), ccfg, "cpu")
    batch = next(synthetic_dlrm_batches(check.batch, ccfg.num_dense,
                                        ccfg.num_tables,
                                        ccfg.rows_per_table, seed=1))
    grads = _cross_device_grads(
        "dlrm_grads", lambda p, b: D.loss_fn(p, b, ccfg), params, batch,
        device)
    emit("dlrm_grads", model=check.model, overrides=dict(check.overrides),
         batch=check.batch, **grads)
    _require_grads("dlrm_grads", grads)
    out["grads"] = grads
    _collect(device == "cuda")
    return out


def phase_rnnt_train(load: RecipeLoad = RNNT_TRAIN_LOAD,
                     check: ZooCheck = RNNT_CHECK, device: str = "cuda",
                     nvidia_smi: str = None) -> dict:
    """The rnnt preset through `recipes.rnnt_speech.build`; then, at its
    width with one encoder layer before and one after the time reduction
    in f32: the card's transducer loss against the float64 oracle on the
    card's log-probs, one step's gradients against the CPU's, and
    `greedy_decode`'s tokens equal to the CPU's."""
    import torch

    from cloudtik_tpu_torch.models import rnnt as N
    from cloudtik_tpu_torch.ops import transducer as X
    from cloudtik_tpu_torch.train.data import synthetic_speech_batches
    from cloudtik_tpu_torch.tree import tree_map

    on_card = device == "cuda"
    out, trainer, _, cfg, args = _recipe_train("rnnt_train", load, device,
                                               nvidia_smi)
    out.update(frames_per_s=out.pop("tokens_per_s"),
               max_frames=args.max_frames, max_labels=args.max_labels,
               num_params=N.num_params(cfg))
    _zoo_phase_end("rnnt_train", out, trainer, on_card)

    ccfg = N.config(check.model, dtype=torch.float32,
                    **dict(check.overrides))
    params = N.init_params(torch.Generator().manual_seed(0), ccfg, "cpu")
    batch = next(synthetic_speech_batches(
        check.batch, check.frames, ccfg.feature_dim, ccfg.vocab_size,
        check.labels, seed=1))
    _zero_zoo_launches()
    grads = _cross_device_grads(
        "rnnt_grads", lambda p, b: N.loss_fn(p, b, ccfg), params, batch,
        device)
    dparams = tree_map(lambda t: t.to(device), params)
    feats = torch.as_tensor(batch["features"], device=device)
    labels = torch.as_tensor(batch["labels"], device=device)
    with torch.no_grad():
        enc = N.encode(dparams, feats, ccfg)
        lp = N.joint(dparams, enc, N.predict(dparams, labels, ccfg), ccfg)
        enc_len = torch.clamp(torch.as_tensor(
            batch["feature_lengths"], device=device).long()
            // ccfg.time_reduction, 1, enc.shape[1])
        lab_len = torch.as_tensor(batch["label_lengths"], device=device)
        loss = X.transducer_loss(lp, labels, enc_len, lab_len).cpu()
    oracle = X.transducer_loss_reference(lp, labels, enc_len, lab_len)
    lattice_rel = (abs(loss.double().numpy() - oracle)
                   / abs(oracle)).max().item()
    tokens = N.greedy_decode(dparams, feats, ccfg).cpu()
    cpu_tokens = N.greedy_decode(params, torch.as_tensor(batch["features"]),
                                 ccfg)
    check_out = {"model": check.model, "overrides": dict(check.overrides),
                 "batch": check.batch, "frames": check.frames,
                 "labels": check.labels,
                 "lattice": [int(lp.shape[1]), int(lp.shape[2])],
                 "transducer_rel_err_vs_oracle": lattice_rel,
                 "transducer_tolerance": TRANSDUCER_REL,
                 "loss_per_example": loss.tolist(),
                 "greedy_tokens_equal": bool(torch.equal(tokens,
                                                         cpu_tokens)),
                 "greedy_symbols": int((tokens != 0).sum()),
                 **grads, "launches": _zoo_launches()}
    emit("rnnt_grads", **check_out)
    require(lattice_rel <= TRANSDUCER_REL,
            f"rnnt_grads: the transducer loss differs from the float64 "
            f"oracle by {lattice_rel} (limit {TRANSDUCER_REL})")
    _require_grads("rnnt_grads", grads)
    require(check_out["greedy_tokens_equal"],
            f"rnnt_grads: greedy_decode on the card gave {tokens.tolist()}, "
            f"on the CPU {cpu_tokens.tolist()}")
    require(not any(check_out["launches"].values()),
            f"rnnt_grads launched {check_out['launches']}")
    out["check"] = check_out
    del dparams, enc, lp
    _collect(on_card)
    return out


def phase_graphsage_train(load: RecipeLoad = GRAPHSAGE_TRAIN_LOAD,
                          link_load: RecipeLoad = GRAPHSAGE_LINK_LOAD,
                          check: ZooCheck = GRAPHSAGE_CHECK,
                          device: str = "cuda",
                          nvidia_smi: str = None) -> dict:
    """The graphsage preset through `recipes.graphsage_nodes.build`:
    supervised node classification, then link prediction; then one f32
    step of the supervised objective, card against CPU."""
    import torch

    from cloudtik_tpu_torch.models import graphsage as G
    from cloudtik_tpu_torch.train.data import synthetic_graph_batches

    on_card = device == "cuda"
    out, trainer, _, cfg, args = _recipe_train("graphsage_train", load,
                                               device, nvidia_smi)
    out.update(nodes_per_s=out.pop("tokens_per_s"), nodes=args.nodes,
               objective=args.objective)
    del trainer
    link, trainer, _, _, link_args = _recipe_train(
        "graphsage_link_pred", link_load, device, nvidia_smi)
    out["link_pred"] = {k: link[k] for k in (
        "losses", "ms_per_step", "launches", "launches_per_step",
        "metrics")}
    out["link_pred"]["edges"] = link_args.nodes // 2
    _require_no_launches("graphsage_link_pred", link)
    _zoo_phase_end("graphsage_train", out, trainer, on_card)

    ccfg = G.config(check.model, dtype=torch.float32,
                    **dict(check.overrides))
    params = G.init_params(torch.Generator().manual_seed(0), ccfg, "cpu")
    batch = next(synthetic_graph_batches(check.batch, ccfg.in_dim,
                                         ccfg.num_classes, ccfg.max_degree,
                                         seed=1))
    grads = _cross_device_grads(
        "graphsage_grads", lambda p, b: G.loss_fn(p, b, ccfg), params,
        batch, device)
    emit("graphsage_grads", model=check.model, nodes=check.batch, **grads)
    _require_grads("graphsage_grads", grads)
    out["grads"] = grads
    _collect(on_card)
    return out


# ----------------------------------------------------------------- gbdt --

@dataclasses.dataclass(frozen=True)
class GbdtLoad:
    """The gbdt phase: the default `GBDTConfig` but `n_trees` (100 trees,
    depth 6, 64 bins, logistic) fit on `rows` synthetic rows of `features`
    features (the width of the UCI HIGGS set, whose 11M rows are cut to
    1M for the script's time), `serve_rows` of them posted to `tik-serve
    --gbdt`, and the cross-device check on `check_rows` rows, logistic and
    softmax at K=3."""
    rows: int = 1_000_000
    features: int = 28
    n_trees: int = 100
    serve_rows: int = 1_000
    check_rows: int = 20_000
    seed: int = 0


GBDT_LOAD = GbdtLoad()
GBDT_REHEARSAL = GbdtLoad(rows=4_000, n_trees=10, serve_rows=50,
                          check_rows=2_000)
# A split may take another candidate on the card when the CPU's best gain
# stands less than this share above its runner-up (the card's scatter-adds
# sum the histograms in another order, ~1e-6 of a gain apart).
GBDT_NEAR_TIE = 1e-4
# Over the rows no flip left out: the raw scores' accumulated |card - CPU|
# (each leaf a sum of gradients in another order, ~1e-7 apart) and the
# probabilities of the two forests.
GBDT_SCORE_ATOL = 1e-4
GBDT_PROBA_ATOL = 1e-4


def gbdt_data(rows: int, features: int, seed: int):
    """Synthetic tabular rows [rows, features] f32 with a binary label and
    a 3-class label, both functions of a few features' interactions plus
    noise (so depth-6 trees have something to find)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((rows, features), dtype=np.float32)
    score = (X[:, 0] * X[:, 1] + np.sin(2 * X[:, 2]) + 0.5 * X[:, 3]
             - 0.3 * X[:, 4] ** 2
             + 0.5 * rng.standard_normal(rows, dtype=np.float32))
    return (X, (score > 0).astype(np.float32),
            np.digitize(score, [-0.5, 0.5]).astype(np.int32))


def node_paths(trees: dict, binned, depth: int):
    """The node every row reaches at every level of one round's K trees
    ([K, 2^d - 1] split arrays) over binned rows [N, F]: [K, depth + 1,
    N], level 0 the root."""
    import torch

    feats = trees["split_feat"].long()
    bins = trees["split_bin"].long()
    X = torch.as_tensor(binned).long()
    rows = torch.arange(X.shape[0])
    node = torch.zeros((feats.shape[0], X.shape[0]), dtype=torch.long)
    paths = [node]
    for level in range(depth):
        idx = 2 ** level - 1 + node
        x = X.t()[feats.gather(1, idx), rows]
        node = node * 2 + (x > bins.gather(1, idx)).long()
        paths.append(node)
    return torch.stack(paths, dim=1)


def compare_round(card: dict, cpu: dict, cpu_gaps: list, binned,
                  depth: int) -> dict:
    """One round's K trees, grown on the card and on the CPU from the same
    scores, compared by the partition each split makes of the training
    rows: a split that differs in (feature, bin) but sends the same rows
    left is equivalent; a node that partitions its rows otherwise must be
    one where the CPU's best gain was a near tie (`GBDT_NEAR_TIE`), and
    its subtree's rows leave the comparison.  Every other row must reach
    the same leaf: its |card leaf - CPU leaf| is returned per row ([K, N],
    0 where left out).  Trees as CPU tensors of [K, ...]."""
    import torch

    pc = node_paths(card, binned, depth)
    pp = node_paths(cpu, binned, depth)
    K, _, N = pp.shape
    flips, at_near_tie = [], True
    left_out = torch.zeros((K, N), dtype=torch.bool)
    for k in range(K):
        for level in range(1, depth + 1):
            rows = (pc[k, level] != pp[k, level]) & ~left_out[k]
            for parent in pp[k, level - 1][rows].unique().tolist():
                gap = float(cpu_gaps[level - 1][k, parent])
                flips.append({"class": k, "level": level - 1,
                              "node": parent, "cpu_gain_gap": gap})
                at_near_tie &= gap < GBDT_NEAR_TIE
                left_out[k] |= pp[k, level - 1] == parent
    leaf_card = card["leaf"].gather(1, pc[:, depth])
    leaf_cpu = cpu["leaf"].gather(1, pp[:, depth])
    differ = ((card["split_feat"] != cpu["split_feat"])
              | (card["split_bin"] != cpu["split_bin"]))
    return {"flips": flips, "at_near_tie": at_near_tie,
            "left_out": left_out, "split_differences": int(differ.sum()),
            "leaf_diff": torch.where(left_out, torch.zeros_like(leaf_cpu),
                                     (leaf_card - leaf_cpu).abs())}


def _gbdt_cross_device(X, labels, cfg, device: str) -> dict:
    """Every round grown twice from the CPU's scores (the CPU's own
    forest): once on the card, once on the CPU, from the same binned rows
    and targets, compared by `compare_round`.  Over the rounds: each flip
    at a near tie, the accumulated |card - CPU| of the raw scores on the
    rows no flip left out within GBDT_SCORE_ATOL, and the probabilities of
    the forest of card trees against the CPU's forest on the rows no flip
    touched within GBDT_PROBA_ATOL."""
    import torch

    from cloudtik_tpu_torch.models import gbdt as GB

    Xb = torch.as_tensor(GB.apply_bins(X, GB.quantile_bins(X, cfg.n_bins)))
    xb = Xb.long()
    xb_card = xb.to(device)
    base, targets = GB.initial_scores(torch.as_tensor(labels), cfg)
    K, N = targets.shape
    scores = base.reshape(-1, 1).expand(K, N).clone()
    drift = torch.zeros((K, N), dtype=torch.float64)
    touched = torch.zeros((K, N), dtype=torch.bool)
    flips, at_near_tie, differences, near_ties = [], True, 0, 0
    card_trees, cpu_trees = [], []
    card_s = cpu_s = 0.0
    for r in range(cfg.n_trees):
        gaps = []
        t0 = time.perf_counter()
        cpu = GB.grow_round(xb, scores, targets, cfg, gaps)
        cpu_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        card = GB.grow_round(xb_card, scores.to(device), targets.to(device),
                             cfg)
        card = {k: v.cpu() for k, v in card.items()}        # waits for it
        card_s += time.perf_counter() - t0
        c = compare_round(card, cpu, gaps, xb, cfg.depth)
        flips += [dict(f, round=r) for f in c["flips"]]
        at_near_tie &= c["at_near_tie"]
        differences += c["split_differences"]
        near_ties += sum(int((g < GBDT_NEAR_TIE).sum()) for g in gaps)
        drift += c["leaf_diff"].double()
        touched |= c["left_out"]
        card_trees.append(card)
        cpu_trees.append(cpu)
        scores = scores + GB.round_scores(cpu, xb, cfg)

    def forest(trees):
        f = {k: torch.stack([t[k] for t in trees]) for k in trees[0]}
        if cfg.objective != "softmax":
            f = {k: v[:, 0] for k, v in f.items()}
        return dict(f, base_score=base)

    clean = ~touched.any(dim=0)                              # [N]
    got = GB.predict_proba(forest(card_trees), xb, cfg)
    want = GB.predict_proba(forest(cpu_trees), xb, cfg)
    proba_err = float((got - want)[clean].abs().max()) if clean.any() \
        else float("nan")
    return {"objective": cfg.objective, "rows": N, "rounds": cfg.n_trees,
            "grow_s_card": card_s, "grow_s_cpu": cpu_s,
            "split_differences": differences, "flips": flips[:20],
            "n_flips": len(flips), "flips_at_near_ties": at_near_tie,
            "near_ties": near_ties,
            "rows_left_out": int(touched.any(dim=0).sum()),
            "score_drift_max": float(drift.max()),
            "score_tolerance": GBDT_SCORE_ATOL,
            "proba_max_abs_err": proba_err,
            "proba_tolerance": GBDT_PROBA_ATOL}


def _serve_gbdt(path: str, rows, device: str, root: str) -> list:
    """`tik-serve --gbdt path` as its own process (the port's `main`),
    `rows` POSTed to /v1/predict; returns the probabilities it answered.
    The process is stopped (SIGTERM, then killed) whatever happens."""
    import queue as queue_mod
    import signal
    import threading

    env = dict(os.environ, TIK_REQLOG_PATH=os.path.join(root, "rl.jsonl"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "cloudtik_tpu_torch.serve.server", "--gbdt",
         path, "--host", "127.0.0.1", "--port", "0", "--device", device],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(Path(__file__).resolve().parent))
    lines = queue_mod.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()
    try:
        try:
            line = lines.get(timeout=180)
        except queue_mod.Empty:
            line = ""
        m = re.search(r"listening on [\d.]+:(\d+)", line)
        require(m is not None, f"gbdt: tik-serve --gbdt did not start: "
                f"{line!r} {proc.poll()}")
        status, body = _http(f"http://127.0.0.1:{m.group(1)}/v1/predict",
                             {"features": rows})
        require(status == 200, f"gbdt: /v1/predict answered {status} {body}")
        proc.send_signal(signal.SIGTERM)
        require(proc.wait(timeout=60) == 0,
                f"gbdt: tik-serve exited {proc.returncode} after SIGTERM")
        return body["probabilities"]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def phase_gbdt(load: GbdtLoad = GBDT_LOAD, device: str = "cuda",
               nvidia_smi: str = None) -> dict:
    """The default GBDT fit on the card over `load.rows` synthetic rows:
    the training log-loss falling tree by tree, ms per tree and predict
    rows/s; the forest saved with its edges and served by `tik-serve
    --gbdt`, whose /v1/predict must equal `predict_proba`; a forest saved
    without edges refused; then the cross-device check
    (`_gbdt_cross_device`), logistic and softmax.  Launch counts are zeroed just before the fit and read after
    the check."""
    import shutil
    import tempfile

    import torch

    from cloudtik_tpu_torch.models import gbdt as GB
    from cloudtik_tpu_torch.serve.server import gbdt_backend

    on_card = device == "cuda"
    L = load
    _collect(on_card)
    X, y, y3 = gbdt_data(L.rows, L.features, L.seed)
    cfg = GB.config(n_trees=L.n_trees)
    t0 = time.perf_counter()
    edges = GB.quantile_bins(X, cfg.n_bins)
    Xb = GB.apply_bins(X, edges)
    bin_s = time.perf_counter() - t0
    _zero_zoo_launches()
    t0 = time.perf_counter()
    forest = GB.fit(Xb, y, cfg, device=device)
    if on_card:
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0

    Xd = torch.as_tensor(Xb, device=device)
    yd = torch.as_tensor(y, device=device)

    def log_loss(k):
        head = {key: (v if key == "base_score" else v[:k])
                for key, v in forest.items()}
        p = GB.predict_proba(head, Xd, cfg).clamp(1e-7, 1 - 1e-7)
        return float(-(yd * torch.log(p) + (1 - yd)
                       * torch.log(1 - p)).mean())

    checkpoints = sorted({0, 1, L.n_trees // 10, L.n_trees // 2, L.n_trees})
    losses = [log_loss(k) for k in checkpoints]
    predict_s = []
    for _ in range(3):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        proba = GB.predict_proba(forest, Xd, cfg)
        if on_card:
            torch.cuda.synchronize()
        predict_s.append(time.perf_counter() - t0)
    accuracy = float(((proba > 0.5).float() == yd).float().mean())
    del Xd, yd, proba

    root = tempfile.mkdtemp(prefix="tik-gbdt-")
    try:
        path = os.path.join(root, "forest.npz")
        GB.save(path, forest, edges)
        rows = X[:L.serve_rows]
        served = _serve_gbdt(path, rows.tolist(), device, root)
        direct = GB.predict_proba(forest, GB.apply_bins(rows, edges),
                                  cfg).cpu().numpy().tolist()
        bare = os.path.join(root, "bare.npz")
        GB.save(bare, forest)
        try:
            gbdt_backend(bare, device=device)
            refused = None
        except ValueError as e:
            refused = str(e)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del forest
    checks = {"logistic": _gbdt_cross_device(
        X[:L.check_rows], y[:L.check_rows], GB.config(n_trees=L.n_trees),
        device),
              "softmax": _gbdt_cross_device(
        X[:L.check_rows], y3[:L.check_rows],
        GB.config(n_trees=L.n_trees, objective="softmax", n_classes=3),
        device)}
    launches = _zoo_launches()
    out = {"nvidia_smi": nvidia_smi, "rows": L.rows,
           "features": L.features, "config": dataclasses.asdict(cfg),
           "bin_s": bin_s, "fit_s": fit_s,
           "ms_per_tree": fit_s / L.n_trees * 1e3,
           "log_loss_at_trees": dict(zip(checkpoints, losses)),
           "train_accuracy": accuracy,
           "predict_ms": min(predict_s) * 1e3,
           "predict_rows_per_s": L.rows / min(predict_s),
           "served_rows": len(served),
           "served_equals_predict_proba": served == direct,
           "refused_without_edges": refused, "checks": checks,
           "launches": launches}
    emit("gbdt", **out)
    require(all(math.isfinite(x) for x in losses)
            and all(b < a for a, b in zip(losses, losses[1:])),
            f"gbdt: the training log-loss did not fall tree by tree: "
            f"{dict(zip(checkpoints, losses))}")
    require(out["served_equals_predict_proba"],
            "gbdt: /v1/predict differs from predict_proba")
    require(refused is not None and "without bin edges" in refused,
            f"gbdt: a forest without edges was not refused ({refused})")
    for name, c in checks.items():
        require(c["flips_at_near_ties"],
                f"gbdt {name}: a split partitions the rows otherwise on the "
                f"card than on the CPU at a node that was not a near tie: "
                f"{c['flips']}")
        require(c["score_drift_max"] <= GBDT_SCORE_ATOL
                and c["proba_max_abs_err"] <= GBDT_PROBA_ATOL,
                f"gbdt {name}: the card's trees score the rows otherwise "
                f"than the CPU's: {c}")
    require(not any(launches.values()), f"gbdt launched {launches}")
    _collect(on_card)
    return out



# -------------------------------------------------------------------- main --

# -------------------------------------------------------------------- MoE --

@dataclasses.dataclass(frozen=True)
class MoeServeLoad:
    """The moe_serve phase: `model` at full width and depth (the server's
    dtypes: f32 parameters, bf16 compute).  `requests` prompts of `prompt`
    tokens (a prefill bucket, so the engine prefills each in one unpadded
    chunk and routes it as `generate` does), `new` greedy tokens each: a
    prefill `forward` over them, the plain server, then `--engine` with
    `clients` concurrent clients of their own prompts."""
    model: str = "tpu_moe_8x1b"
    overrides: tuple = ()
    requests: int = 4
    prompt: int = 128
    new: int = 32
    clients: int = 8
    slots: int = 8
    max_len: int = 256
    block_size: int = 16
    short_new: int = 8        # the planted-fault run's requests


MOE_SERVE_LOAD = MoeServeLoad()
MOE_SERVE_REHEARSAL = MoeServeLoad(model="tiny_moe", prompt=16, new=6,
                                   clients=4, slots=4, max_len=64,
                                   block_size=8, short_new=4)


def moe_planted_fault(params, cfg, load, prompts, device) -> dict:
    """The MoE logits check's power: `load.slots` requests through an
    engine whose decode step gets its block tables rolled one lane on (a
    lane reading another slot's KV), each answer against the teacher
    pinned to the engine's routes; returns the smallest lane's largest
    logits difference and how many lanes the check flags."""
    from cloudtik_tpu_torch.serve.engine import (
        DecodeEngine, EngineConfig, Request)

    eng = DecodeEngine(params, cfg, EngineConfig(
        slots=load.slots, max_len=load.max_len,
        block_size=load.block_size), device=device)
    reqs = [eng.submit(Request(p, max_new_tokens=load.short_new))
            for p in prompts[:load.slots]]
    with StepLogits(eng, "tables") as rec, EngineRoutes(eng) as routes:
        eng.start()
        try:
            outs = [r.wait(timeout=600) for r in reqs]
        finally:
            eng.stop()
    diffs = []
    for r, toks in zip(reqs, outs):
        teacher = generate_teacher(params, cfg, r.prompt, toks, device,
                                   pinned=routes.calls(
                                       r.prompt, r.request_id, len(toks)))
        diffs.append(logits_diff(teacher, rec.rows(r.request_id)))
    return {"fault": "tables", "lanes": len(reqs),
            "logits_diff_min_lane": min(diffs),
            "lanes_flagged_by_logits": sum(d > ENGINE_LOGITS_MAX_ABS
                                           for d in diffs)}


def phase_moe_serve(load: MoeServeLoad = MOE_SERVE_LOAD,
                    device: str = "cuda", nvidia_smi: str = None) -> dict:
    """The MoE inference path.  First the check: the flash `forward` over
    the requests' prompts against the reference-attention forward routed
    as the flash forward routed (the forward's limits: in bf16 the two
    attentions round at different places, so a token near a routing tie
    may route otherwise on each path and change its logits whole, which
    says nothing of attention; how many do, when the reference routes
    itself, is reported).  Then, counts zeroed just before and read just
    after: that `forward` timed (n_layers B1 launches), then
    `tik-serve`'s plain backend answering them (tokens equal a direct
    `generate`; TTFT from a one-token request, TPOT from the rest), then
    `tik-serve --engine` with `clients` concurrent clients (every answer
    tie-aware and every decode step's logits against `generate_teacher`
    pinned to the engine's own routes, `EngineRoutes`), then a planted
    fault (tables rolled one lane on) that the logits check must flag in
    every lane.  Generation and the engine attend with
    einsums, as the reference does: B1 runs in the forward only."""
    import threading

    import numpy as np
    import torch

    from cloudtik_tpu_torch.models import generate as G
    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.ops import flash_attention as FA
    from cloudtik_tpu_torch.serve.server import (ServeServer,
                                                 engine_backend,
                                                 transformer_backend)

    L = load
    on_card = device == "cuda"
    _collect(on_card)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    over = dict(L.overrides)
    backend = transformer_backend(L.model, device=device, **over)
    cfg, params = backend.cfg, backend.params
    V = cfg.vocab_size
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, V, (max(L.requests, L.clients),
                                  L.prompt)).tolist()
    out = {"model": L.model, "nvidia_smi": nvidia_smi,
           "n_layers": cfg.n_layers, "n_experts": cfg.n_experts,
           "top_k": cfg.moe_top_k, "num_params": cfg.num_params(),
           "param_dtype": str(cfg.param_dtype).replace("torch.", ""),
           "dtype": str(cfg.dtype).replace("torch.", ""),
           "prompt": L.prompt, "new": L.new}
    tokens = torch.tensor(prompts[:L.requests], device=device)
    # the check first (its launches are comparisons, not the path)
    ref_cfg = dataclasses.replace(cfg, attention_impl="reference")
    logits, routes = forward_routes(params, tokens, cfg)
    ref, _ = forward_routes(params, tokens, ref_cfg, pinned=routes)
    own = router_flips(routes, forward_routes(params, tokens, ref_cfg)[1],
                       cfg.moe_top_k)
    diff = (logits - ref).abs().max().item()
    rel = ((logits - ref).norm() / ref.norm()).item()
    require(bool(torch.isfinite(logits).all()), "moe_serve: non-finite "
            "logits")
    require(diff <= LOGITS_MAX_ABS and rel <= LOGITS_REL_L2,
            f"moe_serve: forward logits differ from the reference path "
            f"routed alike: max {diff}, rel {rel}")
    del logits, ref, routes
    _zero_launch_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        T.forward(params, tokens, cfg).cpu()
        out["forward_ms"] = (time.perf_counter() - t0) * 1e3
    forward_launches = FA.LAUNCHES
    out["forward"] = {"batch": L.requests, "seq": L.prompt,
                      "flash_launches": forward_launches,
                      "logits_max_abs_diff_vs_reference": diff,
                      "logits_rel_l2_vs_reference": rel,
                      "tolerance": {"max_abs": LOGITS_MAX_ABS,
                                    "rel_l2": LOGITS_REL_L2},
                      "reference_routing_itself": {
                          "tokens": own["tokens"],
                          "tokens_routed_otherwise": len(own["flips"]),
                          "first_flip_gaps_max": max(
                              [f["gap"] for f in own["flips"]],
                              default=None)}}

    server = ServeServer([backend], host="127.0.0.1", port=0)
    server.start()
    url = f"http://127.0.0.1:{server.port}/v1/generate"
    try:
        status, _ = _http(url, {"tokens": [prompts[0][:8]],
                                "max_new_tokens": 2})
        require(status == 200, f"moe_serve warm-up status {status}")
        plain = []
        for i in range(L.requests):
            t0 = time.perf_counter()
            status, body = _http(url, {"tokens": [prompts[i]],
                                       "max_new_tokens": 1})
            ttft = time.perf_counter() - t0
            require(status == 200, f"moe_serve request {i}: {status}")
            t0 = time.perf_counter()
            status, body = _http(url, {"tokens": [prompts[i]],
                                       "max_new_tokens": L.new})
            wall = time.perf_counter() - t0
            require(status == 200, f"moe_serve request {i}: {status} {body}")
            got = body["tokens"][0]
            direct = G.generate(params, torch.tensor([prompts[i]],
                                                     device=device), cfg,
                                max_new_tokens=L.new)[0].tolist()
            require(got == direct, f"moe_serve request {i}: served tokens "
                    "differ from a direct generate")
            plain.append({"ttft_ms": ttft * 1e3, "wall_ms": wall * 1e3,
                          "tpot_ms": (wall - ttft) / (L.new - 1) * 1e3})
        out["plain"] = {
            "requests": L.requests,
            "tokens_per_s": L.requests * L.new
            / sum(p["wall_ms"] for p in plain) * 1e3,
            "ttft_ms": _percentiles([p["ttft_ms"] for p in plain]),
            "tpot_ms": _percentiles([p["tpot_ms"] for p in plain]),
            "equal_direct_generate": True}
    finally:
        server.stop()

    ebackend = engine_backend(L.model, slots=L.slots, max_len=L.max_len,
                              block_size=L.block_size, device=device,
                              params=params, **over)
    engine = ebackend.engine
    server = ServeServer([ebackend], host="127.0.0.1", port=0)
    server.start()
    url = f"http://127.0.0.1:{server.port}/v1/generate"
    try:
        # a warm-up of its own tokens: no block of it is any prompt's prefix
        status, _ = _http(url, {"tokens": [[V - 1] * 8],
                                "max_new_tokens": 2})
        require(status == 200, f"moe_serve engine warm-up status {status}")
        results = [None] * L.clients

        def client(i):
            results[i] = (time.perf_counter(), _http(
                url, {"tokens": [prompts[i]], "max_new_tokens": L.new}),
                time.perf_counter())

        with StepLogits(engine) as rec, EngineRoutes(engine) as routes:
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(L.clients)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
        require(not any(t.is_alive() for t in threads), "a client hung")
        gaps, diffs, exact, lat = [], [], 0, []
        for i, (ts, (status, body), te) in enumerate(results):
            require(status == 200, f"moe_serve engine request {i}: {status}")
            got = body["tokens"][0]
            require(len(got) == L.new and all(0 <= t < V for t in got),
                    f"moe_serve engine request {i}: {got}")
            pinned = routes.calls(prompts[i], body["request_id"], len(got))
            gap, d = check_answer(
                f"moe_serve engine request {i}", params, cfg, prompts[i],
                got, rec, body["request_id"], device,
                teacher_fn=lambda *a, pinned=pinned: generate_teacher(
                    *a, pinned=pinned))
            gaps.append(gap)
            diffs.append(d)
            lat.append((te - ts) * 1e3)
            exact += got == G.generate(
                params, torch.tensor([prompts[i]], device=device), cfg,
                max_new_tokens=L.new)[0].tolist()
        fault = moe_planted_fault(params, cfg, L, prompts, device)
        require(fault["lanes_flagged_by_logits"] == fault["lanes"],
                f"moe_serve: the logits check missed a planted fault: "
                f"{fault}")
        out["engine"] = {
            "clients": L.clients, "slots": L.slots,
            "tokens_per_s": L.clients * L.new / wall,
            "wall_s": wall, "request_ms": _percentiles(lat),
            "tpot_ms_mean": wall / L.new * 1e3,
            "tie_gap_max": max(gaps), "logits_diff_max": max(diffs),
            "tolerance": {"tie_gap": ENGINE_TIE_GAP,
                          "logits_max_abs": ENGINE_LOGITS_MAX_ABS},
            "exact_generate_matches": exact, "planted_fault": fault}
    finally:
        server.stop()
    out["launches"] = _launch_counts()
    out["launches_forward"] = forward_launches
    out["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                          if on_card else None)
    emit("moe_serve", **out)
    want = cfg.n_layers if on_card else 0
    require(forward_launches == want and out["launches"] == {
        "flash_fwd": want, "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
        f"moe_serve launched {out['launches']} ({forward_launches} in the "
        f"forward), expected {want} B1 launches in the forward and none "
        "in generation or the engine")
    # the recorders hold the engine and so the weights: all go before the
    # next phase
    del backend, ebackend, engine, params, rec, routes
    _collect(on_card)
    return out


@dataclasses.dataclass(frozen=True)
class MoeTrainLoad:
    """The moe_train phase: `model` at full width cut to `n_layers` (f32
    parameters, gradients and AdamW moments of tpu_moe_8x1b take 75.7 GB
    at 16 layers, 38.9 GB at 8), bf16 compute, save_attn remat, AdamW at
    `lr` with no warmup (f32 moments: the trainer updates the state in
    place, leaf by leaf); `warmup` then `steps` measured steps on one
    repeated batch."""
    model: str = "tpu_moe_8x1b"
    n_layers: int = 8
    batch: int = 8
    seq: int = 2048
    warmup: int = 2
    steps: int = 5
    lr: float = 1e-3


MOE_TRAIN_LOAD = MoeTrainLoad()
MOE_TRAIN_REHEARSAL = MoeTrainLoad(model="tiny_moe", n_layers=2, batch=2,
                                   seq=64, lr=1e-2)


def phase_moe_train(load: MoeTrainLoad = MOE_TRAIN_LOAD,
                    device: str = "cuda", nvidia_smi: str = None) -> dict:
    """`Trainer.fit` on the MoE model: counts zeroed just before the
    measured steps and read just after, n_layers launches of each of
    B1-B3 a step (save_attn never re-runs the forward kernel), and
    `loss_with_aux` falling on the repeated batch."""
    import torch

    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.train.data import synthetic_lm_batches
    from cloudtik_tpu_torch.train.optim import OptimizerConfig
    from cloudtik_tpu_torch.train.trainer import (
        Trainer, TrainerConfig, transformer_spec)

    L = load
    on_card = device == "cuda"
    _collect(on_card)
    before_gb = torch.cuda.memory_allocated() / 1e9 if on_card else None
    cfg = T.config(L.model, n_layers=L.n_layers, max_seq_len=L.seq,
                   remat=True)
    trainer = Trainer(transformer_spec(cfg), TrainerConfig(
        global_batch_size=L.batch, seq_len=L.seq, log_every=1,
        optimizer=OptimizerConfig(learning_rate=L.lr, warmup_steps=1,
                                  schedule="constant")),
        device=device)
    trainer.init_state(torch.Generator(device=device).manual_seed(0))
    batch = next(synthetic_lm_batches(L.batch, L.seq, cfg.vocab_size,
                                      seed=1))
    train = _train_measured(trainer, iter([batch] * (L.warmup + L.steps)),
                            L.warmup, L.steps, on_card)
    entry = train.pop("last")
    losses = [h["loss_with_aux"] for h in train.pop("history")]
    out = {"model": L.model, "n_layers": L.n_layers,
           "n_experts": cfg.n_experts, "top_k": cfg.moe_top_k,
           "batch": L.batch, "seq": L.seq, "nvidia_smi": nvidia_smi,
           "allocated_before_gb": before_gb,
           "param_dtype": "float32", "dtype": "bfloat16",
           "moment_dtype": "float32",
           "remat_policy": cfg.remat_policy,
           "num_params": cfg.num_params(),
           "active_params": cfg.num_params(active_only=True),
           "flops_per_token": cfg.flops_per_token(),
           "capacity_per_row": cfg.moe_config().capacity(L.seq),
           **train, "losses_with_aux": losses,
           "moe_drop_fraction": entry["moe_drop_fraction"],
           "moe_aux_loss": entry["moe_aux_loss"],
           "moe_z_loss": entry["moe_z_loss"],
           "grad_norm": entry["grad_norm"]}
    emit("moe_train", **out)
    _check_losses("moe_train", losses)
    n = L.n_layers if on_card else 0
    require(out["launches_per_step"] == {"flash_fwd": n, "flash_bwd_dq": n,
                                         "flash_bwd_dkv": n},
            f"moe_train step launches {out['launches_per_step']}, expected "
            f"{n} of each kernel")
    del trainer
    _collect(on_card)
    return out


@dataclasses.dataclass(frozen=True)
class MoeGradsLoad:
    """The moe_grads phase: `model`'s widths at `n_layers`, f32 with TF32
    off, one batch on the card and on the CPU; greedy `generate` of
    `gen_new` tokens after a `gen_prompt`-token prompt on both."""
    model: str = "tpu_moe_8x1b"
    n_layers: int = 2
    batch: int = 2
    seq: int = 256
    gen_prompt: int = 32
    gen_new: int = 16


MOE_GRADS_LOAD = MoeGradsLoad()
MOE_GRADS_REHEARSAL = MoeGradsLoad(model="tiny_moe", seq=32, gen_prompt=8,
                                   gen_new=6)
# A token's top-k choice may differ between the card and the CPU only at a
# near tie: where two of its first k+1 router probabilities (in f32, TF32
# off) lie within MOE_TIE_GAP.  Either side's f32 router logits differ by
# ~1e-6; a wrong router weight moves them by far more.
MOE_TIE_GAP = 1e-4


def forward_routes(params, tokens, cfg, pinned: list = None):
    """(logits, every MoE layer's router probabilities [B, S, E] on the
    CPU) of one forward of `tokens`; with `pinned` (such a list) every
    MoE layer routes by those probabilities instead of its own."""
    import torch

    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.ops import moe as TM

    real, seen = TM.router_probs, []

    def recording(x, w):
        probs, logits = real(x, w)
        if pinned is not None:
            probs = pinned[len(seen)].to(probs.device)
        seen.append(probs.detach().cpu())
        return probs, logits

    TM.router_probs = recording
    try:
        with torch.no_grad():
            logits = T.forward(params, tokens, cfg)
    finally:
        TM.router_probs = real
    return logits, seen


def router_flips(got: list, ref: list, top_k: int,
                 limit: float = MOE_TIE_GAP) -> dict:
    """Tokens whose ordered top-k experts differ between `got`'s and
    `ref`'s router probabilities (per layer), each with its gap: on each
    side the smallest between two adjacent ones of its first k+1
    probabilities, the larger side's (a near tie must be one on both
    sides).  A token is taken at its first differing layer (what follows
    from there is that flip's doing).  `all_at_near_tie`: every token's
    first flip lies at a gap <= `limit`."""
    import torch

    def adjacent_gaps(p):
        top = torch.topk(p, top_k + 1, dim=-1)
        return top, (top.values[..., :-1] - top.values[..., 1:]).min(-1).values

    flips, seen = [], set()
    for layer, (a, b) in enumerate(zip(got, ref)):
        (ka, gaps_a), (kb, gaps_b) = adjacent_gaps(a), adjacent_gaps(b)
        differ = (ka.indices[..., :top_k] != kb.indices[..., :top_k]).any(-1)
        gaps = torch.maximum(gaps_a, gaps_b)
        for idx in differ.nonzero().tolist():
            if tuple(idx) in seen:
                continue
            seen.add(tuple(idx))
            flips.append({"layer": layer, "row": idx[0], "pos": idx[1],
                          "gap": float(gaps[tuple(idx)])})
    return {"tokens": got[0].shape[0] * got[0].shape[1] if got else 0,
            "flips": flips, "limit": limit,
            "all_at_near_tie": all(f["gap"] <= limit for f in flips)}


def phase_moe_grads(load: MoeGradsLoad = MOE_GRADS_LOAD,
                    device: str = "cuda") -> dict:
    """The MoE model at `load.model`'s widths, `n_layers` deep, f32: every
    gradient leaf on the card within ZOO_GRAD_REL_L2 relative L2 of the
    CPU's from the same parameters; every token whose routing differs at a
    near tie of router probabilities; greedy `generate` equal."""
    import torch

    from cloudtik_tpu_torch.models import generate as G
    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.train.data import synthetic_lm_batches
    from cloudtik_tpu_torch.tree import tree_map

    L = load
    _collect(device == "cuda")
    cfg = T.config(L.model, n_layers=L.n_layers, max_seq_len=L.seq,
                   dtype=torch.float32, remat=False)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = next(synthetic_lm_batches(L.batch, L.seq, cfg.vocab_size,
                                      seed=1))
    grads = _cross_device_grads(
        "moe_grads", lambda p, b: T.loss_fn(p, b, cfg), params, batch,
        device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        on_dev = tree_map(lambda t: t.to(device), params)
        tokens = torch.as_tensor(batch["tokens"]).long()
        probs = [forward_routes(p, tokens.to(p["embed"].device), cfg)[1]
                 for p in (on_dev, params)]
        flips = router_flips(*probs, cfg.moe_top_k)
        prompt = tokens[:1, :L.gen_prompt]
        gen = [G.generate(p, prompt.to(p["embed"].device), cfg,
                          max_new_tokens=L.gen_new)[0].tolist()
               for p in (on_dev, params)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out = {"model": L.model, "n_layers": L.n_layers, "batch": L.batch,
           "seq": L.seq, **grads, "routed_tokens_per_layer":
           flips["tokens"], "routing_flips": flips["flips"],
           "tie_gap_limit": MOE_TIE_GAP, "generate_card": gen[0],
           "generate_cpu": gen[1]}
    emit("moe_grads", **out)
    _require_grads("moe_grads", grads)
    require(flips["all_at_near_tie"],
            f"moe_grads: a token's routing differs between the card and the "
            f"CPU away from a near tie: {flips['flips'][:5]}")
    require(gen[0] == gen[1], f"moe_grads: greedy tokens differ: card "
            f"{gen[0]}, CPU {gen[1]}")
    del on_dev, params
    _collect(device == "cuda")
    return out


# ---------------------------------------------------------- parallel_2rank --
# Two ranks share card 0 over gloo (NCCL refuses two ranks on one device):
# every time in this phase is a time of that arrangement, host-staged
# collectives included, and none is a multi-GPU number.
PARALLEL_LABEL = ("two ranks sharing one H100 over gloo (host-staged), "
                  "not NCCL")
# One step's gradients on two ranks against one rank, per leaf in relative
# L2: in bf16 compute (train_grads' limit: the split rounds each rank's
# partial products to bf16 before their sum), and in f32 with TF32 off,
# where only the order of the sums differs.
PARALLEL_BF16_REL_L2 = GRADS_REL_L2
PARALLEL_F32_REL_L2 = 1e-3


@dataclasses.dataclass(frozen=True)
class ParallelLoad:
    """The parallel_2rank phase.  `model` at full width throughout: the
    tensor=2 step at full depth (`tensor_batch` x `seq`, `steps` measured
    after one warm-up); pipe=2 at full depth (`pipe_batch` x `seq`,
    `pipe_micro` microbatches, `steps` measured after one warm-up) under
    GPipe and 1F1B, and both again at `pipe_micro_peak` for the peak; the
    f32 checks (tensor, pipe under
    each schedule, seq) at `check_layers` layers, `check_batch` x
    `check_seq`; data=2 with 2 accumulated microbatches at `check_layers`
    layers, `overlap_steps` steps with the overlapped sync and without;
    each collective's cost at `collective_mib` MiB of f32."""
    model: str = "tpu_1b"
    device: str = "cuda:0"
    seq: int = 2048
    tensor_batch: int = 4
    steps: int = 2
    pipe_batch: int = 8
    pipe_micro: int = 4
    pipe_micro_peak: int = 8
    check_layers: int = 2
    check_batch: int = 2
    check_seq: int = 1024
    overlap_batch: int = 4
    overlap_steps: int = 3
    lr: float = 1e-3
    collective_mib: int = 32
    deadline_s: float = 600.0


PARALLEL_LOAD = ParallelLoad()
PARALLEL_REHEARSAL = ParallelLoad(
    model="tiny", device="cpu", seq=64, tensor_batch=2, pipe_batch=4,
    pipe_micro=2, pipe_micro_peak=4, check_batch=2, check_seq=32,
    lr=1e-2, collective_mib=1, deadline_s=300.0)


def _rank_batch(B: int, S: int, vocab: int, seed: int) -> dict:
    from cloudtik_tpu_torch.train.data import synthetic_lm_batches

    return next(synthetic_lm_batches(B, S, vocab, seed=seed))


def _on(batch: dict, device) -> dict:
    import torch

    return {k: torch.as_tensor(v).long().to(device) for k, v in batch.items()}


def _reference_grads(cfg, params, batch: dict, chunks: int):
    """One rank's loss and gradients of `batch` (on the device), summed
    over `chunks` row chunks: every row has as many valid labels, so the
    mean of the chunks' losses is the batch's."""
    import torch

    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten

    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    leaves = tree_leaves(p)
    rows = batch["tokens"].shape[0] // chunks
    total, loss_sum = None, 0.0
    for c in range(chunks):
        sub = {k: v[c * rows:(c + 1) * rows] for k, v in batch.items()}
        loss, _ = T.loss_fn(p, sub, cfg)
        grads = torch.autograd.grad(loss, leaves)
        loss_sum += float(loss)
        total = [g.float() / chunks for g in grads] if total is None else [
            t + g.float() / chunks for t, g in zip(total, grads)]
    return loss_sum / chunks, tree_unflatten(params, total)


def _sharded_gaps(trainer, grads, ref) -> dict:
    """{leaf: relative L2 of this mesh's gradient to the one-rank one}
    over each whole leaf: each rank's squared sums over its slice, summed
    over the axes the leaf is split on."""
    import torch
    import torch.distributed as dist

    from cloudtik_tpu_torch.tree import tree_leaves

    out = {}
    for (name, r), g, pl in zip(_named_leaves(ref), tree_leaves(grads),
                                tree_leaves(trainer._placements)):
        r = trainer._shard(r, pl).float()
        sums = torch.stack([(g.float() - r).square().sum(),
                            r.square().sum()]).double()
        for axis in pl.axes:
            dist.all_reduce(sums, group=trainer.mesh.get_group(axis))
        out[name] = math.sqrt(float(sums[0]) / max(float(sums[1]), 1e-300))
    return out


def _mesh_trainer(cfg, mesh: dict, B: int, S: int, device, lr: float,
                  **config):
    from cloudtik_tpu_torch.parallel.mesh import MeshConfig
    from cloudtik_tpu_torch.train.optim import OptimizerConfig
    from cloudtik_tpu_torch.train.trainer import (
        Trainer, TrainerConfig, transformer_spec)

    return Trainer(transformer_spec(cfg), TrainerConfig(
        global_batch_size=B, seq_len=S, mesh=MeshConfig(**{"fsdp": 1,
                                                           **mesh}),
        optimizer=OptimizerConfig(learning_rate=lr, warmup_steps=1,
                                  schedule="constant"),
        log_every=1, prefetch_depth=0, **config), device=device)


def _init(cfg, device):
    import torch

    from cloudtik_tpu_torch.models import transformer as T

    return T.init_params(torch.Generator(device=device).manual_seed(0), cfg,
                         device)


class _PlantedHeadNoCopy:
    """models/transformer.py's `collectives` with x reaching the split lm
    head without `copy_to`: its gradient then holds this rank's vocab
    slice only."""

    def __init__(self, real):
        self.real = real

    def __getattr__(self, name):
        return getattr(self.real, name)

    def copy_to(self, x, axes):
        if sys._getframe(1).f_code.co_name == "loss_fn":
            return x
        return self.real.copy_to(x, axes)


def _check_step(load: ParallelLoad, device, mesh: dict, bf16: bool,
                fault=None, batch: int = None, **overrides) -> dict:
    """One step's loss and gradients on `mesh` against one rank's on the
    same card: at full depth in bf16 (`batch` rows, by default
    `tensor_batch`), or at `check_layers` in f32."""
    import torch
    import torch.distributed as dist

    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.train.data import local_batch

    if bf16:
        cfg = T.config(load.model, max_seq_len=load.seq, **overrides)
        B, S = batch or load.tensor_batch, load.seq
    else:
        cfg = T.config(load.model, n_layers=load.check_layers,
                       dtype=torch.float32, max_seq_len=load.check_seq,
                       **overrides)
        B, S = load.check_batch, load.check_seq
    full = _init(cfg, device)
    rows = _rank_batch(B, S, cfg.vocab_size, seed=1)
    ref_loss, ref = _reference_grads(cfg, full, _on(rows, device),
                                     chunks=max(B // 2, 1))
    trainer = _mesh_trainer(cfg, mesh, B, S, device, load.lr)
    trainer.init_state(params=full)
    mine = _on(local_batch(rows, trainer.mesh), device)
    real = T.collectives
    if fault == "head_no_copy":
        T.collectives = _PlantedHeadNoCopy(real)
    try:
        grads, metrics = trainer._grads(mine)
    finally:
        T.collectives = real
    if fault == "head_pipe_summed":
        dist.all_reduce(grads["lm_head"], group=trainer.mesh.get_group("pipe"))
    gaps = _sharded_gaps(trainer, grads, ref)
    worst = max(gaps, key=gaps.get)
    out = {"mesh": mesh, "dtype": "bfloat16" if bf16 else "float32",
           "n_layers": cfg.n_layers, "batch": B, "seq": S, "fault": fault,
           "loss": float(metrics["loss"]), "reference_loss": ref_loss,
           "loss_rel": abs(float(metrics["loss"]) - ref_loss) / ref_loss,
           "max_leaf_rel_l2": gaps[worst], "worst_leaf": worst,
           "median_leaf_rel_l2": sorted(gaps.values())[len(gaps) // 2]}
    del trainer, grads, ref, full
    _collect(torch.device(device).type == "cuda")
    return out


def _q_shapes():
    """Record the q shape of every B1 launch (a set, filled as they run)."""
    from cloudtik_tpu_torch.ops import flash_attention as FA

    seen = set()
    real = FA._kernel_fwd

    def recorded(q, *args, **kwargs):
        seen.add(tuple(q.shape))
        return real(q, *args, **kwargs)

    FA._kernel_fwd = recorded
    return seen, lambda: setattr(FA, "_kernel_fwd", real)


def _train_on_mesh(load: ParallelLoad, device, cfg, mesh: dict, B: int,
                   warmup: int, steps: int) -> dict:
    """`Trainer.fit` on `mesh`: `warmup` steps, then `steps` measured with
    the launch counts zeroed just before and read just after; B1's q
    shapes; the losses on the repeated batch; ms/step, tokens/s, peak."""
    import torch

    on_card = torch.device(device).type == "cuda"
    trainer = _mesh_trainer(cfg, mesh, B, load.seq, device, load.lr)
    trainer.init_state(params=_init(cfg, device))
    batch = _rank_batch(B, load.seq, cfg.vocab_size, seed=1)
    shapes, undo = _q_shapes()
    try:
        train = _train_measured(trainer, iter([batch] * (warmup + steps)),
                                warmup, steps, on_card)
    finally:
        undo()
    entry = train.pop("last")
    train.pop("history")
    out = {**train, "q_shapes": sorted(shapes),
           "mfu_one_card": (cfg.flops_per_token() * entry["tokens_per_sec"]
                            / PEAK_BF16_FLOPS) if on_card else None,
           "grad_norm": entry["grad_norm"]}
    out.pop("mfu", None)
    del trainer
    _collect(on_card)
    return out


def _peak_of_grads(load: ParallelLoad, device, cfg, mesh: dict,
                   B: int) -> float:
    """Peak GB of one step's gradients on `mesh` (None off the card)."""
    import torch

    from cloudtik_tpu_torch.train.data import local_batch

    on_card = torch.device(device).type == "cuda"
    trainer = _mesh_trainer(cfg, mesh, B, load.seq, device, load.lr)
    trainer.init_state(params=_init(cfg, device))
    batch = _on(local_batch(_rank_batch(B, load.seq, cfg.vocab_size, 1),
                            trainer.mesh), device)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    grads, _ = trainer._grads(batch)
    peak = None
    if on_card:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
    del trainer, grads
    _collect(on_card)
    return peak


def _collective_costs(load: ParallelLoad, device) -> dict:
    """ms of each collective the layer issues, over the world group, at
    `collective_mib` MiB of f32 a rank, and the route a shift takes."""
    import torch
    import torch.distributed as dist

    from cloudtik_tpu_torch.parallel import collectives

    n = load.collective_mib * (1 << 20) // 4
    world = dist.get_world_size()
    group = dist.group.WORLD
    x = torch.ones(n, device=device)
    ops = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            x.new_empty(n * world), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            x.new_empty(n // world), x),
        "shift": lambda: collectives.shift_many([x], group, 1),
    }
    out = {"mib": load.collective_mib,
           "shift_route": collectives.shift_route(group, x.device)}
    for name, fn in ops.items():
        fn()
        _sync_all(device)
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        _sync_all(device)
        out[f"{name}_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    try:        # 16-bit reductions run in f32 (collectives._sum_over)
        dist.all_reduce(x[:1024].to(torch.bfloat16))
        out["bf16_all_reduce"] = "ok"
    except Exception as e:  # recorded: the port never depends on it
        out["bf16_all_reduce"] = f"{type(e).__name__}: {e}"[:200]
    return out


def _sync_all(device) -> None:
    import torch
    import torch.distributed as dist

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    dist.barrier()


def _overlap_runs(load: ParallelLoad, device) -> dict:
    """data=2, 2 accumulated microbatches, `check_layers` layers of
    `model` in bf16: `overlap_steps` steps with the overlapped sync and
    with the sequential one, from one state and one data stream."""
    import torch

    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.train.data import synthetic_lm_batches

    on_card = torch.device(device).type == "cuda"
    cfg = T.config(load.model, n_layers=load.check_layers,
                   max_seq_len=load.seq)
    out = {}
    for overlap in (False, True):
        trainer = _mesh_trainer(cfg, {"data": 2}, load.overlap_batch,
                                load.seq, device, load.lr,
                                grad_accum_steps=2,
                                overlap_grad_sync=overlap)
        trainer.init_state(params=_init(cfg, device))
        t0 = time.perf_counter()
        hist = trainer.fit(synthetic_lm_batches(
            load.overlap_batch, load.seq, cfg.vocab_size, seed=2),
            load.overlap_steps)["history"]
        out["overlap" if overlap else "sequential"] = {
            "enabled": trainer.overlap_enabled(),
            "losses": [h["loss"] for h in hist],
            "ms_per_step": (time.perf_counter() - t0)
            / load.overlap_steps * 1e3,
            "last_sync_ms": trainer._last_sync_s * 1e3}
        del trainer
        _collect(on_card)
    return out


def parallel_rank(load: ParallelLoad, out_dir: str) -> int:
    """One rank of the parallel_2rank phase (run by `phase_parallel_2rank`
    through `parallel.launch.run_ranks`); writes rank<r>.json."""
    import torch
    import torch.distributed as dist

    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.parallel import distributed

    distributed.auto_initialize(backend="gloo")
    device = torch.device(load.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    rank = dist.get_rank()
    full = T.config(load.model)
    L = full.n_layers
    res = {"rank": rank, "label": PARALLEL_LABEL,
           "collectives": _collective_costs(load, device)}
    # ---- tensor=2 at full depth: gradients, then the measured steps ----
    t0 = time.perf_counter()
    res["tensor_grads"] = _check_step(load, device, {"tensor": 2}, True)
    res["tensor_train"] = _train_on_mesh(
        load, device, T.config(load.model, max_seq_len=load.seq),
        {"tensor": 2}, load.tensor_batch, 1, load.steps)
    res["tensor_f32"] = _check_step(load, device, {"tensor": 2}, False)
    res["tensor_f32_fault"] = _check_step(load, device, {"tensor": 2},
                                          False, fault="head_no_copy")
    res["tensor_s"] = time.perf_counter() - t0
    # ---- pipe=2 at full depth under both schedules ----
    t0 = time.perf_counter()
    res["pipe"] = {}
    for schedule in ("gpipe", "1f1b"):
        over = dict(pipeline_schedule=schedule,
                    pipeline_microbatches=load.pipe_micro)
        cfg = T.config(load.model, max_seq_len=load.seq, **over)
        res["pipe"][schedule] = {
            "grads": _check_step(load, device, {"pipe": 2}, True,
                                 batch=load.pipe_batch, **over),
            "train": _train_on_mesh(load, device, cfg, {"pipe": 2},
                                    load.pipe_batch, 1, load.steps),
            "f32": _check_step(load, device, {"pipe": 2}, False,
                               pipeline_schedule=schedule,
                               pipeline_microbatches=2),
            "peak_gb_at_peak_micro": _peak_of_grads(
                load, device, T.config(
                    load.model, max_seq_len=load.seq,
                    pipeline_schedule=schedule,
                    pipeline_microbatches=load.pipe_micro_peak),
                {"pipe": 2}, load.pipe_batch)}
    res["pipe_f32_fault"] = _check_step(
        load, device, {"pipe": 2}, False, fault="head_pipe_summed",
        pipeline_microbatches=2)
    res["pipe_s"] = time.perf_counter() - t0
    # ---- seq=2 (the ring through the shift) and the overlapped sync ----
    t0 = time.perf_counter()
    res["seq_f32"] = _check_step(load, device, {"seq": 2}, False)
    res["overlap"] = _overlap_runs(load, device)
    res["rest_s"] = time.perf_counter() - t0
    res["n_layers"] = L
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_parallel_2rank(load: ParallelLoad = PARALLEL_LOAD,
                         nvidia_smi: str = None) -> dict:
    """Two ranks on card 0 over gloo (`parallel_rank`), both spawned by
    `run_ranks` with the load's deadline; their results checked here."""
    import tempfile

    import torch

    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.parallel.launch import run_ranks

    on_card = load.device.startswith("cuda")
    _collect(on_card)
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        spec = Path(tmp) / "load.json"
        spec.write_text(json.dumps(dataclasses.asdict(load)))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(root)] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        run_ranks([str(root / "chip_smoke.py"), "--parallel-rank",
                   str(spec), tmp], 2, load.deadline_s, env=env,
                  cwd=str(root))
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(2)]
    wall_s = time.perf_counter() - t0
    cfg = T.config(load.model)
    L, H, Dh = cfg.n_layers, cfg.n_heads, cfg.head_dim
    M = load.pipe_micro
    # per rank and step: the tensor step runs every layer on H/2 heads;
    # a pipe stage runs its L/2 layers once a microbatch, and 1F1B's
    # backward recomputes each stage's forward (B1 again)
    want = {"tensor": dict.fromkeys(
                ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), L),
            "gpipe": dict.fromkeys(
                ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), L // 2 * M),
            "1f1b": {"flash_fwd": 2 * (L // 2) * M,
                     "flash_bwd_dq": L // 2 * M,
                     "flash_bwd_dkv": L // 2 * M}}
    out = {"model": load.model, "label": PARALLEL_LABEL,
           "nvidia_smi": nvidia_smi, "wall_s": wall_s,
           "expected_launches_per_step": want, "ranks": ranks}
    emit("parallel_2rank", **out)
    launches = {k: 0 for k in want["tensor"]}
    for r in ranks:
        got = {"tensor": r["tensor_train"]["launches_per_step"],
               "gpipe": r["pipe"]["gpipe"]["train"]["launches_per_step"],
               "1f1b": r["pipe"]["1f1b"]["train"]["launches_per_step"]}
        for path in (r["tensor_train"], r["pipe"]["gpipe"]["train"],
                     r["pipe"]["1f1b"]["train"]):
            for k in launches:
                launches[k] += path["launches"][k]
        if on_card:
            require(got == want, f"rank {r['rank']}: launches per step "
                    f"{got}, expected {want}")
            q = [load.tensor_batch, H // 2, load.seq, Dh]
            require(r["tensor_train"]["q_shapes"] == [q],
                    f"tensor step B1 q shapes {r['tensor_train']['q_shapes']}"
                    f", expected {q}")
        _check_losses("parallel_2rank tensor", r["tensor_train"]["losses"])
        for schedule in ("gpipe", "1f1b"):
            _check_losses(f"parallel_2rank pipe {schedule}",
                          r["pipe"][schedule]["train"]["losses"])
        for name, c in (("tensor", r["tensor_grads"]),
                        ("gpipe", r["pipe"]["gpipe"]["grads"]),
                        ("1f1b", r["pipe"]["1f1b"]["grads"])):
            require(c["max_leaf_rel_l2"] <= PARALLEL_BF16_REL_L2
                    and c["loss_rel"] <= PARALLEL_BF16_REL_L2,
                    f"{name} bf16 step against one rank: {c}")
        for name, c in (("tensor", r["tensor_f32"]),
                        ("gpipe", r["pipe"]["gpipe"]["f32"]),
                        ("1f1b", r["pipe"]["1f1b"]["f32"]),
                        ("seq", r["seq_f32"])):
            require(c["max_leaf_rel_l2"] <= PARALLEL_F32_REL_L2
                    and c["loss_rel"] <= PARALLEL_F32_REL_L2,
                    f"{name} f32 step against one rank: {c}")
        for name in ("tensor_f32_fault", "pipe_f32_fault"):
            require(r[name]["max_leaf_rel_l2"] > PARALLEL_F32_REL_L2,
                    f"the planted fault {name} was not flagged: {r[name]}")
        ov = r["overlap"]
        require(ov["overlap"]["enabled"] and not ov["sequential"]["enabled"]
                and ov["overlap"]["losses"] == ov["sequential"]["losses"],
                f"overlapped and sequential losses differ: {ov}")
        if on_card:
            peaks = {s: r["pipe"][s]["peak_gb_at_peak_micro"]
                     for s in ("gpipe", "1f1b")}
            require(peaks["1f1b"] < peaks["gpipe"],
                    f"rank {r['rank']}: 1F1B peaks at {peaks['1f1b']} GB, "
                    f"GPipe at {peaks['gpipe']} GB")
    out["launches"] = launches
    emit("parallel_2rank_launches", launches=launches)
    return out


# ----------------------------------------------------------- elastic_2rank --
@dataclasses.dataclass(frozen=True)
class ElasticLoad:
    """The elastic_2rank phase: `model` at full width and full depth, two
    ranks on one card over gloo, each a slice of per-slice layout data=1,
    fsdp=1; global batch `batch` x `seq` in the train phase's
    configuration (bf16 params and moments, save_attn), a save every
    `every` steps.  The save of `torn_at` tears, slice 1 is lost at
    boundary `lost_at`, the survivor re-meshes to K=1 and trains to
    `return_at`, slice 1 returns as a fresh process and the job expands to
    K=2 and trains to `steps`.  `n_layers` (0: the preset's) cuts the
    depth, `param_dtype` sets the params' and moments' dtype, and `rules`
    overrides the sharding rules ({logical axis: mesh axes})."""
    model: str = "tpu_1b"
    device: str = "cuda:0"
    seq: int = 2048
    batch: int = 8
    steps: int = 8
    every: int = 2
    torn_at: int = 4
    lost_at: int = 4
    return_at: int = 6
    deadline_s: float = 900.0
    n_layers: int = 0
    param_dtype: str = "bfloat16"
    rules: dict = dataclasses.field(default_factory=dict)


# the story at half of tpu_1b's 16 layers (full width): the depth cut that
# keeps the whole script within 1,100 s of its 1,200 s limit
ELASTIC_LOAD = ElasticLoad(n_layers=8)
ELASTIC_REHEARSAL = ElasticLoad(model="tiny", device="cpu", seq=64,
                                deadline_s=300.0)
# F5: an expand under rules that split the embedding over `data` (rows
# over the slices at K=2, whole at K=1), held to the default rules' run of
# the same story: 2 layers at full width, f32, a shorter story (lost at 2,
# back at 3, one K=2 step after the expand); both run at once
ELASTIC_SPLIT_RULES = {"embed": ["data", None]}
ELASTIC_SPLIT_LOAD = ElasticLoad(n_layers=2, param_dtype="float32",
                                 steps=4, every=1, torn_at=2, lost_at=2,
                                 return_at=3, deadline_s=600.0)
ELASTIC_SPLIT_REHEARSAL = dataclasses.replace(
    ELASTIC_SPLIT_LOAD, model="tiny", device="cpu", seq=64,
    deadline_s=300.0)
# f32 losses of the two layouts, step by step after the expand
ELASTIC_SPLIT_REL = 1e-5
ELASTIC_LABEL = ("two processes sharing one H100 over gloo (host-staged), "
                 "not NCCL")


def _elastic_trainer(load: ElasticLoad, device, checkpoint_dir: str,
                     every: int, mesh=None):
    import torch

    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.parallel.sharding import make_rules
    from cloudtik_tpu_torch.train.optim import OptimizerConfig
    from cloudtik_tpu_torch.train.trainer import (
        Trainer, TrainerConfig, transformer_spec)

    depth = {"n_layers": load.n_layers} if load.n_layers else {}
    cfg = T.config(load.model, max_seq_len=load.seq,
                   param_dtype=getattr(torch, load.param_dtype), **depth)
    rules = make_rules(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in load.rules.items()})
    return Trainer(transformer_spec(cfg), TrainerConfig(
        global_batch_size=load.batch, seq_len=load.seq, log_every=1,
        optimizer=OptimizerConfig(moment_dtype=load.param_dtype),
        rules=rules, checkpoint_every=every, checkpoint_dir=checkpoint_dir,
        prefetch_depth=0), device=device, mesh=mesh), cfg


def _elastic_data(load: ElasticLoad, vocab: int):
    from cloudtik_tpu_torch.train.data import synthetic_lm_batches

    def factory(step):
        return itertools.islice(synthetic_lm_batches(
            load.batch, load.seq, vocab, seed=5), step, None)
    return factory


def _state_digest(state) -> dict:
    """{leaf path: sha256 of its bytes} of a state on any device."""
    import hashlib

    import torch

    from cloudtik_tpu_torch.train.checkpoint import _flatten

    out = {}
    for path, leaf in _flatten(state):
        key = ".".join(map(str, path))
        if isinstance(leaf, torch.Tensor):
            data = leaf.detach().contiguous().cpu().reshape(-1)
            out[key] = hashlib.sha256(
                data.view(torch.uint8).numpy().tobytes()).hexdigest()
        else:
            out[key] = repr(leaf)
    return out


def elastic_rank(load: ElasticLoad, out_dir: str) -> int:
    """One process of the elastic_2rank phase (run by
    `phase_elastic_2rank` through `run_ranks`): rank 0
    survives; rank 1's first process leaves at the lost boundary (writes
    rank1.left.json and exits `launch.LEFT`) and its second joins at the
    return; each writes rank<r>.json."""
    import torch
    import torch.distributed as dist

    from cloudtik_tpu_torch import telemetry
    from cloudtik_tpu_torch.faults import seams
    from cloudtik_tpu_torch.faults.plan import FaultPlan, FaultPoint
    from cloudtik_tpu_torch.parallel import distributed, launch
    from cloudtik_tpu_torch.parallel.mesh import MeshConfig
    from cloudtik_tpu_torch.telemetry import events, goodput
    from cloudtik_tpu_torch.train import checkpoint as ckpt_lib
    from cloudtik_tpu_torch.train.elastic import (ElasticCoordinator,
                                                  StoreMembership)

    rank = int(os.environ["RANK"])
    joining = launch.incarnation() > 0
    device = torch.device(load.device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    else:
        torch.set_num_threads(1)
    telemetry.enable()
    out = Path(out_dir)
    events.install(str(out / f"events.rank{rank}.{int(joining)}.jsonl"))
    store = distributed.elastic_store(str(out / "store"), load.deadline_s)
    groups = {0: [0], 1: [1]}
    membership = StoreMembership(store, groups)
    coord = ElasticCoordinator(
        membership, mesh_config=MeshConfig(data=1, fsdp=1),
        slice_devices=groups, store=store, rank=rank, backend="gloo",
        remesh_dwell_s=0.0, checkpoint_wait_s=load.deadline_s,
        timeout_s=load.deadline_s)
    ckpt_dir = str(out / "ckpt")
    if joining:
        trainer, cfg = _elastic_trainer(load, device, ckpt_dir, load.every)
    else:
        mesh = coord.build_mesh()
        trainer, cfg = _elastic_trainer(load, device, ckpt_dir, load.every,
                                        mesh=mesh)
        trainer.init_state(torch.Generator(device=device).manual_seed(0))
    factory = _elastic_data(load, cfg.vocab_size)
    # the GB the shards write and read, each re-mesh's seconds by part
    io = {"written_bytes": 0, "read_bytes": 0}
    save, read_file = trainer.checkpointer.save, ckpt_lib._read_file

    def counted_save(step, state, force=False, shard=None):
        started = save(step, state, force=force, shard=shard)
        if started:
            io["written_bytes"] += sum(
                v.numel() * v.element_size() for _, v in state
                if isinstance(v, torch.Tensor))
        return started

    def counted_read(root, entry):
        t = read_file(root, entry)
        io["read_bytes"] += t.numel() * t.element_size()
        return t

    trainer.checkpointer.save = counted_save
    ckpt_lib._read_file = counted_read
    remeshes = []
    apply_remesh = trainer._apply_remesh
    buckets = (goodput.BUCKET_CHECKPOINT_SAVE,
               goodput.BUCKET_CHECKPOINT_RESTORE,
               goodput.BUCKET_ELASTIC_REMESH, goodput.BUCKET_COMPILE)

    def timed_remesh(decision, coordinator):
        before = [goodput.LEDGER.total(b) for b in buckets]
        t0 = time.perf_counter()
        apply_remesh(decision, coordinator)
        wall = time.perf_counter() - t0
        wait, restore, rest, compiled = (
            goodput.LEDGER.total(b) - a for b, a in zip(buckets, before))
        remeshes.append({"direction": decision.direction,
                         "to_slices": list(decision.to_slices),
                         "step": trainer.step, "wall_s": wall,
                         "wait_s": wait, "restore_s": restore,
                         "rest_s": rest, "compile_s": compiled})
        if decision.direction == "shrink" and rank == 0:
            # the restored commit, kept (hard links) for the fresh one-card
            # run the K=1 era is held to: retention deletes it later
            import shutil

            shutil.copytree(trainer.checkpointer._step_dir(trainer.step),
                            out / "ref" / str(trainer.step),
                            copy_function=os.link)

    trainer._apply_remesh = timed_remesh
    marks = []
    fired = {"back": False}

    def callback(t, entry):
        marks.append({"step": entry["step"], "slices": len(coord.current),
                      "launches": _launch_counts()})
        if (entry["step"] != load.return_at or fired["back"]
                or len(coord.current) != 1):
            return
        # the survivor brings slice 1 back: a fresh process, which
        # registers before this boundary's poll
        fired["back"] = True
        (out / "return.rank1.json").write_text(json.dumps({"case": "e"}))
        launch.request_return(1)
        deadline = time.monotonic() + load.deadline_s
        while 1 not in membership.alive_slices():
            require(time.monotonic() < deadline,
                    "elastic_2rank: slice 1 did not come back")
            time.sleep(0.05)

    plan = FaultPlan([
        FaultPoint("checkpoint.save", "torn_write", times=1,
                   match={"step": load.torn_at}),
        FaultPoint("elastic.slice_lost", "drop", times=1,
                   match={"slice": 1, "step": load.lost_at})], seed=42)
    # ---- the main path: counts zeroed just before, read just after ----
    _zero_launch_counts()
    t0 = time.perf_counter()
    with seams.armed(plan):
        res = trainer.fit_elastic(factory, load.steps, coord,
                                  callbacks=[callback], join=joining)
    wall_s = time.perf_counter() - t0
    launches = _launch_counts()
    prev = dict.fromkeys(launches, 0)
    per_step = []
    for m in marks:
        per_step.append({"step": m["step"], "slices": m["slices"], **{
            k: m["launches"][k] - prev[k] for k in launches}})
        prev = m["launches"]
    result = {"rank": rank, "joined": joining, "label": ELASTIC_LABEL,
              "history": res["history"], "launches": launches,
              "launches_by_step": per_step, "remeshes": remeshes,
              "wall_s": wall_s, **io,
              "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                          if on_card else None)}
    if res.get("left"):
        result["left_at"] = res["final_step"]
        (out / f"rank{rank}.left.json").write_text(json.dumps(result))
        return launch.LEFT
    trainer.checkpointer.wait()
    dist.barrier()      # every rank's last shard is in
    result.update(
        final_step=res["final_step"], slices=list(coord.current),
        world=dist.get_world_size(),
        buckets=dict(goodput.LEDGER.snapshot()["buckets"]),
        committed=trainer.checkpointer.all_steps(),
        events=[e for e in events.read_events()
                if e["name"] in ("tik_elastic_remesh", "tik_train_resume")],
        split_over_data=sorted(
            ".".join(map(str, path)) for path, pl in ckpt_lib._flatten(
                trainer._placements) if "data" in pl.axes),
        # the whole state: a leaf split over `data` is gathered
        digest=_state_digest(trainer.full_state()))
    trainer.checkpointer.close()
    (out / f"rank{rank}.json").write_text(json.dumps(result))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_elastic_2rank(load: ElasticLoad = ELASTIC_LOAD,
                        nvidia_smi: str = None,
                        determinism: dict = None,
                        split_load: ElasticLoad = ELASTIC_SPLIT_LOAD) -> dict:
    """The elastic story over two processes on one card (`elastic_rank`,
    spawned by `run_ranks` with the load's deadline),
    checked here; then a fresh one-card trainer restored from the commit
    the shrink resumed from runs the K=1 era's steps, whose losses the
    survivor's must equal (within twice the checkpoint phase's probe gap
    when `determinism` says that probe was not bitwise); then the story
    at `split_load` under rules that split over `data` against the
    default rules (`_elastic_split`)."""
    import shutil
    import tempfile

    import torch

    from cloudtik_tpu_torch.tree import tree_leaves

    on_card = load.device.startswith("cuda")
    _collect(on_card)
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tik-elastic-")
    try:
        # ---- room for max_to_keep + 1 steps of a replica's state, or a
        # loud failure ----
        probe, _ = _elastic_trainer(load, "cpu", str(Path(tmp) / "x"), 1)
        keep = probe.checkpointer.config.max_to_keep
        state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(
            probe._abstract_state()) if isinstance(t, torch.Tensor))
        del probe
        free = shutil.disk_usage(tmp).free
        need = (keep + 1) * state_bytes
        disk = {"state_bytes": state_bytes, "free_bytes": free,
                "needed_bytes": need}
        require(free >= need, f"elastic_2rank: {free} bytes free under "
                f"{tmp}, {need} needed for {keep + 1} steps")
        ranks = _elastic_drill(load, root, tmp)
        survivor, joiner, left = (ranks[who] for who in (
            "survivor", "joiner", "left"))
        spawn_s = time.perf_counter() - t0
        # ---- the fresh one-card run from the commit the shrink resumed
        # from, over the K=1 era's steps ----
        shrink = survivor["remeshes"][0]
        era = [h for h in survivor["history"] if h["slices"] == 1]
        fresh, cfg = _elastic_trainer(load, load.device,
                                      str(Path(tmp) / "ref"), 1000)
        fresh.restore_checkpoint(step=shrink["step"])
        fresh_losses = [h["loss"] for h in fresh.fit(
            _elastic_data(load, cfg.vocab_size)(shrink["step"]),
            len(era))["history"]]
        del fresh
        _collect(on_card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    L = cfg.n_layers
    B, S = load.batch, load.seq

    def ms_by_k(r, k):
        return [B * S / h["tokens_per_sec"] * 1e3 for h in r["history"]
                if h["slices"] == k]

    tol = 0.0
    if determinism and not determinism.get("bitwise", True):
        tol = determinism["resume_tolerance"]
    k1_losses = [h["loss"] for h in era]
    out = {"model": load.model, "label": ELASTIC_LABEL,
           "nvidia_smi": nvidia_smi, "batch": B, "seq": S,
           "param_dtype": "bfloat16", "moment_dtype": "bfloat16",
           "disk": disk, "wall_s": time.perf_counter() - t0,
           "spawn_s": spawn_s,
           "ms_per_step": {"k2": ms_by_k(survivor, 2),
                           "k1": ms_by_k(survivor, 1),
                           "k2_joiner": ms_by_k(joiner, 2)},
           "remeshes": {"survivor": survivor["remeshes"],
                        "joiner": joiner["remeshes"]},
           "shards_gb": {"written": (survivor["written_bytes"]
                                     + left["written_bytes"]
                                     + joiner["written_bytes"]) / 1e9,
                         "read": (survivor["read_bytes"]
                                  + joiner["read_bytes"]) / 1e9},
           "peak_gb": {"survivor": survivor["peak_gb"],
                       "left": left["peak_gb"], "joiner": joiner["peak_gb"]},
           "k1_losses": k1_losses, "fresh_losses": fresh_losses,
           "loss_tolerance": tol,
           "steps": [(h["step"], h["slices"]) for h in survivor["history"]],
           "buckets": survivor["buckets"], "committed": survivor["committed"],
           "launches_by_step": {"survivor": survivor["launches_by_step"],
                                "left": left["launches_by_step"],
                                "joiner": joiner["launches_by_step"]}}
    emit("elastic_2rank", **out)
    # ---- the checks ----
    lost, back = load.lost_at, load.return_at
    restored = lost - load.every
    want = ([(s, 2) for s in range(1, lost + 1)]
            + [(s, 1) for s in range(restored + 1, back + 1)]
            + [(s, 2) for s in range(back + 1, load.steps + 1)])
    require(out["steps"] == want, f"elastic_2rank steps and slices "
            f"{out['steps']}, expected {want}")
    require([(h["step"], h["slices"]) for h in joiner["history"]]
            == want[-(load.steps - back):], "elastic_2rank: the returned "
            f"process ran {joiner['history']}")
    require(left["left_at"] == lost and [h["step"] for h in left["history"]]
            == list(range(1, lost + 1)), f"elastic_2rank: the lost "
            f"process left at {left.get('left_at')}")
    require(shrink["direction"] == "shrink" and shrink["step"] == restored
            and [r["direction"] for r in survivor["remeshes"]]
            == ["shrink", "expand"], f"elastic_2rank re-meshes "
            f"{survivor['remeshes']}")
    require(len(fresh_losses) == len(k1_losses) and all(
        abs(a - b) <= tol for a, b in zip(k1_losses, fresh_losses)),
        f"elastic_2rank: K=1 losses {k1_losses}, a fresh one-card run from "
        f"step {restored}: {fresh_losses} (tolerance {tol})")
    for a, b in zip(k1_losses, k1_losses[1:]):
        require(math.isfinite(a) and math.isfinite(b), "elastic_2rank: "
                f"K=1 losses {k1_losses}")
    require(survivor["digest"] == joiner["digest"], "elastic_2rank: the "
            "two replicas' state differs after the expand: " + str(
                [k for k in survivor["digest"]
                 if survivor["digest"][k] != joiner["digest"].get(k)][:5]))
    require(survivor["buckets"]["elastic_remesh"] > 0
            and survivor["buckets"]["restart_replay"] > 0,
            f"elastic_2rank goodput {survivor['buckets']}")
    launches = {k: survivor["launches"][k] + left["launches"][k]
                + joiner["launches"][k] for k in survivor["launches"]}
    if on_card:
        each = dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                             L)
        for who, steps in out["launches_by_step"].items():
            for m in steps:
                got = {k: m[k] for k in each}
                require(got == each, f"elastic_2rank {who} step "
                        f"{m['step']} (K={m['slices']}) launched {got}, "
                        f"expected {each}")
    # ---- F5: the expand under rules that split over `data` ----
    split = _elastic_split(split_load, root, nvidia_smi)
    out["split"] = split
    for k in launches:
        launches[k] += split["launches"][k]
    out["launches"] = launches
    emit("elastic_2rank_launches", launches=launches)
    return out


def _elastic_drill(load: ElasticLoad, root: Path, tmp: str) -> dict:
    """One run of the elastic story (`elastic_rank` in two processes, over
    the directory `tmp`): {"survivor", "joiner", "left"} as the ranks
    wrote them."""
    from cloudtik_tpu_torch.parallel.launch import run_ranks

    spec = Path(tmp) / "load.json"
    spec.write_text(json.dumps(dataclasses.asdict(load)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    run_ranks([str(root / "chip_smoke.py"), "--elastic-rank", str(spec),
               tmp], 2, load.deadline_s, env=env, cwd=str(root))
    return {who: json.loads((Path(tmp) / name).read_text())
            for who, name in (("survivor", "rank0.json"),
                              ("joiner", "rank1.json"),
                              ("left", "rank1.left.json"))}


def _elastic_split(load: ElasticLoad, root: Path,
                   nvidia_smi: str = None) -> dict:
    """F5 (Trainer._hand_over): the story at `load` twice at once, under
    the default rules and under `ELASTIC_SPLIT_RULES`; the split run's
    K=2 layout splits the embedding over `data`, its expand hands the
    split leaves over block by block, and every f32 loss after the expand
    is the default run's within `ELASTIC_SPLIT_REL` relative.  Both
    replicas hold the same whole state after each run."""
    import shutil
    import tempfile
    import threading

    runs, failures = {}, []

    def run(name, drill_load):
        tmp = tempfile.mkdtemp(prefix="tik-elastic-")
        try:
            runs[name] = _elastic_drill(drill_load, root, tmp)
        except BaseException as e:      # re-raised below
            failures.append(e)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(name, drill_load))
               for name, drill_load in (
                   ("default", load),
                   ("split", dataclasses.replace(
                       load, rules=ELASTIC_SPLIT_RULES)))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if failures:
        raise failures[0]
    wall_s = time.perf_counter() - t0
    on_card = load.device.startswith("cuda")
    restored = load.lost_at - load.every
    want = ([(s, 2) for s in range(1, load.lost_at + 1)]
            + [(s, 1) for s in range(restored + 1, load.return_at + 1)]
            + [(s, 2) for s in range(load.return_at + 1, load.steps + 1)])
    losses = {name: [h["loss"] for h in r["survivor"]["history"]]
              for name, r in runs.items()}
    rel = [abs(a - b) / max(abs(b), 1e-30)
           for a, b in zip(losses["split"], losses["default"])]
    after = [r for (step, k), r in zip(want, rel) if step > load.return_at]
    launches = {k: sum(r[who]["launches"][k] for r in runs.values()
                       for who in ("survivor", "joiner", "left"))
                for k in runs["split"]["survivor"]["launches"]}
    out = {"label": ELASTIC_LABEL, "nvidia_smi": nvidia_smi,
           "load": dataclasses.asdict(load), "rules": ELASTIC_SPLIT_RULES,
           "wall_s": wall_s, "losses": losses, "rel": rel,
           "max_rel_after_expand": max(after) if after else None,
           "split_over_data": runs["split"]["survivor"]["split_over_data"],
           "expand_s": {name: [m["wall_s"] for m in r["survivor"]["remeshes"]
                               if m["direction"] == "expand"]
                        for name, r in runs.items()},
           "launches": launches}
    emit("elastic_split", **out)
    for name, r in runs.items():
        got = [(h["step"], h["slices"]) for h in r["survivor"]["history"]]
        require(got == want, f"elastic_split {name}: steps and slices "
                f"{got}, expected {want}")
        require([(h["step"], h["slices"]) for h in r["joiner"]["history"]]
                == want[-(load.steps - load.return_at):],
                f"elastic_split {name}: the returned process ran "
                f"{r['joiner']['history']}")
        require(r["survivor"]["digest"] == r["joiner"]["digest"],
                f"elastic_split {name}: the replicas' whole state differs "
                "after the expand")
        require(all(math.isfinite(x) for x in losses[name]),
                f"elastic_split {name}: losses {losses[name]}")
    require(runs["default"]["survivor"]["split_over_data"] == []
            and "embed" in out["split_over_data"],
            f"elastic_split: leaves split over data "
            f"{out['split_over_data']} under {ELASTIC_SPLIT_RULES}, "
            f"{runs['default']['survivor']['split_over_data']} under the "
            "default rules")
    require(after and max(after) <= ELASTIC_SPLIT_REL,
            f"elastic_split: f32 losses after the expand {losses['split']} "
            f"against the default rules' {losses['default']} (relative "
            f"{rel}, limit {ELASTIC_SPLIT_REL})")
    if on_card:
        from cloudtik_tpu_torch.models import transformer as T

        each = dict.fromkeys(launches, load.n_layers
                             or T.config(load.model).n_layers)
        for name, r in runs.items():
            for who in ("survivor", "joiner", "left"):
                for m in r[who]["launches_by_step"]:
                    got = {k: m[k] for k in each}
                    require(got == each, f"elastic_split {name} {who} step "
                            f"{m['step']} launched {got}, expected {each}")
    return out


# ------------------------------------------------------------ zoo_2rank --
@dataclasses.dataclass(frozen=True)
class ZooMeshLoad:
    """The zoo_2rank phase: two ranks on card 0 over gloo.  Mask R-CNN
    (`maskrcnn` at `image_size`, the maskrcnn_coco recipe's configuration)
    at data=2 on a global batch of `maskrcnn_batch` (4 a rank: the JAX
    launch line's per-card batch): one f32 step with TF32 off against one
    process on the same global batch, the same step with BN on local
    statistics (planted), then `warmup` + `steps` steps in the recipe's
    bf16 configuration and one more step with every collective timed.
    DLRM (`dlrm`) at fsdp=2 on `dlrm_batch`: one f32 step against one
    process, then `dlrm_warmup` + `dlrm_steps` steps in bf16.  GraphSAGE
    (`graphsage`) at data=2 on blocks of `graphsage_nodes` nodes: one f32
    step of each objective against one process, and the supervised one
    reading only its own rows (planted)."""
    device: str = "cuda:0"
    maskrcnn: str = "maskrcnn_resnet50"
    image_size: int = 512
    maskrcnn_batch: int = 8
    warmup: int = 2
    steps: int = 3
    dlrm: str = "criteo_terabyte"
    dlrm_batch: int = 8192
    dlrm_warmup: int = 1
    dlrm_steps: int = 2
    graphsage: str = "graphsage"
    graphsage_nodes: int = 4096
    deadline_s: float = 600.0


ZOO_MESH_LOAD = ZooMeshLoad()
ZOO_MESH_REHEARSAL = ZooMeshLoad(
    device="cpu", maskrcnn="tiny", image_size=64, maskrcnn_batch=4,
    warmup=1, steps=1, dlrm="tiny", dlrm_batch=64, dlrm_steps=1,
    graphsage="tiny", graphsage_nodes=64, deadline_s=300.0)
# a mesh step against one process in f32 with TF32 off, the loss and each
# leaf in relative L2: only the order of the sums differs (the zoo's
# card-against-CPU limit)
ZOO_MESH_REL_L2 = ZOO_GRAD_REL_L2
# Mask R-CNN's backbone at random weights is ill-conditioned in f32: BN
# normalises channels whose mean dwarfs their spread, so a change in the
# order of its sums alone moves every leaf's gradient by ~1% (maskrcnn at
# 128 px on the CPU: f32 against f64 0.78% largest leaf, the two-pass
# statistics against `var`'s 0.98%, tools/probe_torch_maskrcnn_mesh.py;
# the card's mesh step 3.2%).
# Its leaves are held to this many times the gaps of that witness, on one
# process and measured in the same run; BN on local statistics moves them
# by ~100%.
ZOO_MESH_WITNESS_FACTOR = 3.0
ZOO_MESH_LABEL = PARALLEL_LABEL


class _CollectivesWith:
    """parallel/collectives.py with the given functions replaced (a
    planted fault in one model module)."""

    def __init__(self, **replaced):
        self._replaced = replaced

    def __getattr__(self, name):
        from cloudtik_tpu_torch.parallel import collectives

        return self._replaced.get(name, getattr(collectives, name))


def _own_rows_only(x, axes=("data", "fsdp")):
    """`gather_rows`'s shape holding only this rank's rows of x, the
    other ranks' zero."""
    import torch

    from cloudtik_tpu_torch.parallel import sharding

    n, index = 1, 0
    for a in axes:
        size = sharding.mesh_axis_size(a)
        index = index * size + sharding.axis_rank(a)
        n *= size
    zeros = x.new_zeros(x.shape)
    return torch.cat([x if i == index else zeros for i in range(n)])


class _PinnedProposals:
    """`maskrcnn.propose` pinned to one process's choice: each image's
    top-K proposals are a discrete pick from objectness scores that a
    batch split moves by rounding, and at random weights near ties are
    many, so a flipped pick would move every ROI loss.  `recording()`
    keeps the proposals of the one-process call (rank 0's), `share()`
    broadcasts them, and under `pinning()` each call gets this rank's
    rows of them; `differ` counts the proposals this rank's own pick
    would have replaced (a box more than 1e-4 away)."""

    def __init__(self, module, k: int):
        self.module, self.real, self.k = module, module.propose, k
        self.boxes = self.scores = None
        self.differ = 0

    @contextlib.contextmanager
    def recording(self):
        def record(*args, **kwargs):
            self.boxes, self.scores = self.real(*args, **kwargs)
            return self.boxes, self.scores
        self.module.propose = record
        try:
            yield
        finally:
            self.module.propose = self.real

    def share(self, batch: int, device) -> None:
        import torch
        import torch.distributed as dist

        if self.boxes is None:
            self.boxes = torch.zeros((batch, self.k, 4), device=device)
            self.scores = torch.zeros((batch, self.k), device=device)
        for t in (self.boxes, self.scores):
            dist.broadcast(t.contiguous(), src=0)

    @contextlib.contextmanager
    def pinning(self):
        from cloudtik_tpu_torch.parallel import sharding

        def pinned(obj, *args, **kwargs):
            own, _ = self.real(obj, *args, **kwargs)
            per = obj.shape[0]
            index = (sharding.axis_rank("data")
                     * sharding.mesh_axis_size("fsdp")
                     + sharding.axis_rank("fsdp"))
            rows = slice(index * per, (index + 1) * per)
            boxes = self.boxes[rows]
            # another box, not the same box rounded otherwise
            self.differ += int(((own - boxes).abs().amax(-1) > 1e-4).sum())
            return boxes, self.scores[rows]
        self.differ = 0
        self.module.propose = pinned
        try:
            yield
        finally:
            self.module.propose = self.real


def _two_pass_batch_norm(x, scale, bias, eps: float):
    """`resnet._batch_norm` with its statistics taken as a mesh takes them
    (a sum over the rows, then the sum of squared deviations) on one
    process: the same function, its sums in another order."""
    import torch

    x32 = x.float()
    n = x32.numel() // x32.shape[-1]
    mean = x32.sum(dim=(0, 1, 2), keepdim=True) / n
    var = (x32 - mean).square().sum(dim=(0, 1, 2), keepdim=True) / n
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    return (normed * scale.float() + bias.float()).to(x.dtype)


def _leaf_gaps(got, want) -> dict:
    """The largest and the median relative L2 of `got`'s leaves to
    `want`'s (whole trees on this rank)."""
    from cloudtik_tpu_torch.tree import tree_leaves

    rel = {n: ((a.double() - w.double()).norm()
               / max(w.double().norm().item(), 1e-300)).item()
           for (n, w), a in zip(_named_leaves(want), tree_leaves(got))}
    worst = max(rel, key=rel.get)
    return {"max_leaf_rel_l2": rel[worst], "worst_leaf": worst,
            "median_leaf_rel_l2": sorted(rel.values())[len(rel) // 2]}


def _on_device(batch: dict, device) -> dict:
    import numpy as np
    import torch

    from cloudtik_tpu_torch.train.trainer import _as_long

    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(device)
            for k, v in _as_long(batch).items()}


def _family_trainer(spec, mesh: dict, B: int, device, optimizer=None):
    from cloudtik_tpu_torch.parallel.mesh import MeshConfig
    from cloudtik_tpu_torch.train.optim import OptimizerConfig
    from cloudtik_tpu_torch.train.trainer import Trainer, TrainerConfig

    return Trainer(spec, TrainerConfig(
        global_batch_size=B, seq_len=1,
        mesh=MeshConfig(**{"fsdp": 1, **mesh}),
        optimizer=optimizer or OptimizerConfig(), log_every=1,
        prefetch_depth=0), device=device)


def _one_process_grads(spec, params, batch: dict, device):
    """Rank 0's loss and gradients of `spec` on the whole global batch
    (one process), broadcast to every rank: (loss, gradient tree)."""
    import torch
    import torch.distributed as dist

    from cloudtik_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten

    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    leaves = tree_leaves(p)
    box = [None]
    if dist.get_rank() == 0:
        loss, _ = spec.loss_fn(p, _on_device(batch, device))
        # contiguous: a conv kernel's gradient comes back in the layout
        # cuDNN or the CPU computed it in, and a broadcast moves storage
        grads = [g.contiguous() for g in torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)]
        box = [loss.item()]
        del loss
    else:
        grads = [torch.zeros_like(t) for t in leaves]
    dist.broadcast_object_list(box, src=0)
    for g in grads:
        dist.broadcast(g, src=0)
    return box[0], tree_unflatten(params, [g.detach() for g in grads])


def _mesh_step(spec, params, batch: dict, mesh: dict, device, ref_loss,
               ref, fault=None) -> dict:
    """One step's loss and gradients of `spec` on `mesh` (this rank's
    rows of `batch`, the trainer's gathers and sums) against one
    process's: the loss and each whole leaf's relative L2; `fault` is
    (module, its planted `collectives`)."""
    from cloudtik_tpu_torch.train.data import local_batch

    B = len(next(iter(batch.values())))
    trainer = _family_trainer(spec, mesh, B, device)
    trainer.init_state(params=params)
    mine = _on_device(local_batch(batch, trainer.mesh,
                                  seq_split=spec.seq_split), device)
    if fault is not None:
        module, planted = fault
        real, module.collectives = module.collectives, planted
    try:
        grads, metrics = trainer._grads(mine)
    finally:
        if fault is not None:
            module.collectives = real
    gaps = _sharded_gaps(trainer, grads, ref)
    worst = max(gaps, key=gaps.get)
    loss = float(metrics["loss"])
    out = {"mesh": mesh, "batch": B, "loss": loss, "reference_loss": ref_loss,
           "loss_rel": abs(loss - ref_loss) / abs(ref_loss),
           "max_leaf_rel_l2": gaps[worst], "worst_leaf": worst,
           "median_leaf_rel_l2": sorted(gaps.values())[len(gaps) // 2],
           "leaves": len(gaps)}
    del trainer, grads
    return out


def _collective_ms(trainer, batch: dict, on_card: bool) -> dict:
    """One more step of `trainer` on the global `batch` with every
    torch.distributed collective timed, the card synchronised around each
    (so the step is slower than a measured one): their ms and count."""
    import torch
    import torch.distributed as dist

    names = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
             "broadcast")
    real = {n: getattr(dist, n) for n in names}
    spent = {n: [0.0, 0] for n in names}

    def timed(name):
        def call(*args, **kwargs):
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = real[name](*args, **kwargs)
            if on_card:
                torch.cuda.synchronize()
            spent[name][0] += time.perf_counter() - t0
            spent[name][1] += 1
            return result
        return call

    for n in names:
        setattr(dist, n, timed(n))
    try:
        t0 = time.perf_counter()
        trainer.fit(iter([batch]), 1)
        if on_card:
            torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for n in names:
            setattr(dist, n, real[n])
    return {"collective_ms": sum(v[0] for v in spent.values()) * 1e3,
            "by_kind": {n: {"ms": v[0] * 1e3, "calls": v[1]}
                        for n, v in spent.items() if v[1]},
            "instrumented_step_ms": step_ms}


def _timed_steps(trainer, batch: dict, warmup: int, steps: int,
                 on_card: bool) -> dict:
    """`_train_measured` on a repeated global batch, then one step with the
    collectives timed; the losses finite."""
    train = _train_measured(trainer, itertools.repeat(batch), warmup, steps,
                            on_card, detection=True)
    train.pop("history")
    entry = train.pop("last")
    train["grad_norm"] = entry["grad_norm"]
    train["collectives"] = _collective_ms(trainer, batch, on_card)
    return train


def zoo_rank(load: ZooMeshLoad, out_dir: str) -> int:
    """One rank of the zoo_2rank phase (run by `phase_zoo_2rank` through
    `parallel.launch.run_ranks`); writes rank<r>.json."""
    import torch
    import torch.distributed as dist

    from cloudtik_tpu_torch.models import dlrm as DL
    from cloudtik_tpu_torch.models import graphsage as G
    from cloudtik_tpu_torch.models import maskrcnn as MR
    from cloudtik_tpu_torch.models import resnet as R
    from cloudtik_tpu_torch.parallel import distributed
    from cloudtik_tpu_torch.recipes.graphsage_nodes import with_edges
    from cloudtik_tpu_torch.train import data as TD
    from cloudtik_tpu_torch.train.optim import OptimizerConfig
    from cloudtik_tpu_torch.train.trainer import (dlrm_spec, graphsage_spec,
                                                  maskrcnn_spec)

    distributed.auto_initialize(backend="gloo")
    device = torch.device(load.device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    rank = dist.get_rank()
    res = {"rank": rank, "label": ZOO_MESH_LABEL}

    def init(M, cfg):
        return M.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg, device)

    def checks(spec, params, batch, mesh, faults=(), pin=None):
        with pin.recording() if pin else contextlib.nullcontext():
            ref_loss, ref = _one_process_grads(spec, params, batch, device)
        out = {}
        if pin:
            pin.share(len(batch["images"]), device)
            # what a change of BN's summation order alone moves, on one
            # process: the backbone at random weights normalises channels
            # whose mean dwarfs their spread, where f32 cancels
            real_bn, R._batch_norm = R._batch_norm, _two_pass_batch_norm
            try:
                with pin.pinning():
                    w_loss, witness = _one_process_grads(spec, params, batch,
                                                         device)
            finally:
                R._batch_norm = real_bn
            out["witness"] = {"loss_rel": abs(w_loss - ref_loss)
                              / abs(ref_loss), **_leaf_gaps(witness, ref)}
            del witness
        for name, fault in (("clean", None), *faults):
            with pin.pinning() if pin else contextlib.nullcontext():
                out[name] = _mesh_step(spec, params, batch, mesh, device,
                                       ref_loss, ref, fault)
            if pin:
                out[name]["proposals_repicked"] = pin.differ
        del ref
        _collect(on_card)
        return out

    # ---- Mask R-CNN at data=2: f32 against one process, then bf16 ----
    t0 = time.perf_counter()
    cfg = MR.config(load.maskrcnn, image_size=load.image_size)
    batch = next(TD.synthetic_detection_batches(
        load.maskrcnn_batch, cfg.image_size, cfg.num_classes, cfg.max_boxes,
        mask_size=2 * cfg.mask_pool, seed=1))
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    res["maskrcnn_f32"] = checks(
        maskrcnn_spec(cfg32), init(MR, cfg32), batch, {"data": 2},
        [("bn_local", (R, _CollectivesWith(groups_for=lambda axes: ())))],
        pin=_PinnedProposals(MR, cfg32.num_proposals))
    trainer = _family_trainer(maskrcnn_spec(cfg), {"data": 2},
                              load.maskrcnn_batch, device)
    trainer.init_state(torch.Generator(device=device).manual_seed(0))
    res["maskrcnn_train"] = _timed_steps(trainer, batch, load.warmup,
                                         load.steps, on_card)
    del trainer
    _collect(on_card)
    res["maskrcnn_s"] = time.perf_counter() - t0

    # ---- DLRM at fsdp=2: f32 against one process, then bf16 ----
    t0 = time.perf_counter()
    cfg = DL.config(load.dlrm)
    batch = next(TD.synthetic_dlrm_batches(
        load.dlrm_batch, cfg.num_dense, cfg.num_tables, cfg.rows_per_table,
        seed=1))
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    res["dlrm_f32"] = checks(dlrm_spec(cfg32), init(DL, cfg32), batch,
                             {"fsdp": 2})
    trainer = _family_trainer(dlrm_spec(cfg), {"fsdp": 2}, load.dlrm_batch,
                              device, OptimizerConfig(warmup_steps=0))
    trainer.init_state(torch.Generator(device=device).manual_seed(0))
    res["dlrm_train"] = _timed_steps(trainer, batch, load.dlrm_warmup,
                                     load.dlrm_steps, on_card)
    res["dlrm_local_table"] = list(trainer.params["embeddings"].shape)
    del trainer
    _collect(on_card)
    res["dlrm_s"] = time.perf_counter() - t0

    # ---- GraphSAGE at data=2, both objectives in f32 ----
    t0 = time.perf_counter()
    cfg32 = G.config(load.graphsage, dtype=torch.float32)
    params = init(G, cfg32)
    block = next(with_edges(TD.synthetic_graph_batches(
        load.graphsage_nodes, cfg32.in_dim, cfg32.num_classes,
        cfg32.max_degree, seed=1), load.graphsage_nodes))
    nodes = {k: v for k, v in block.items()
             if k not in ("src", "dst", "neg_dst")}
    res["graphsage_f32"] = checks(
        graphsage_spec(cfg32), params, nodes, {"data": 2},
        [("own_rows", (G, _CollectivesWith(gather_rows=_own_rows_only)))])
    res["graphsage_link_f32"] = checks(
        graphsage_spec(cfg32, "link_pred"), params, block, {"data": 2})
    res["graphsage_s"] = time.perf_counter() - t0
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _zoo_mesh_limits(check: dict) -> dict:
    """A mesh step's limits against one process, per leaf in relative L2:
    ZOO_MESH_REL_L2, or where a sum-order witness was measured (Mask
    R-CNN's BN) ZOO_MESH_WITNESS_FACTOR times its largest and its median
    leaf when that is more."""
    w = check.get("witness")
    if w is None:
        return {"max": ZOO_MESH_REL_L2, "median": ZOO_MESH_REL_L2}
    return {k: max(ZOO_MESH_REL_L2,
                   ZOO_MESH_WITNESS_FACTOR * w[f"{k}_leaf_rel_l2"])
            for k in ("max", "median")}


def phase_zoo_2rank(load: ZooMeshLoad = ZOO_MESH_LOAD,
                    nvidia_smi: str = None) -> dict:
    """Two ranks on card 0 over gloo (`zoo_rank`), spawned by `run_ranks`
    with the load's deadline; their results checked here: every f32 step
    within ZOO_MESH_REL_L2 of one process (loss and each leaf), each
    planted fault past it, on the card 2 ROIAlign launches a rank and
    Mask R-CNN step and no other B1-B5 launch, finite losses."""
    import tempfile

    from cloudtik_tpu_torch.parallel.launch import run_ranks

    on_card = load.device.startswith("cuda")
    _collect(on_card)
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        spec = Path(tmp) / "load.json"
        spec.write_text(json.dumps(dataclasses.asdict(load)))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(root)] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        run_ranks([str(root / "chip_smoke.py"), "--zoo-rank", str(spec),
                   tmp], 2, load.deadline_s, env=env, cwd=str(root))
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(2)]
    out = {"label": ZOO_MESH_LABEL, "nvidia_smi": nvidia_smi,
           "wall_s": time.perf_counter() - t0,
           "load": dataclasses.asdict(load),
           "tolerance_rel_l2": ZOO_MESH_REL_L2, "ranks": ranks}
    emit("zoo_2rank", **out)
    launches = {"nms": 0, "roi_align": 0}
    for r in ranks:
        for name in ("maskrcnn_f32", "dlrm_f32", "graphsage_f32",
                     "graphsage_link_f32"):
            c, limits = r[name]["clean"], _zoo_mesh_limits(r[name])
            require(c["max_leaf_rel_l2"] <= limits["max"]
                    and c["median_leaf_rel_l2"] <= limits["median"]
                    and c["loss_rel"] <= ZOO_MESH_REL_L2,
                    f"zoo_2rank {name} against one process: {c} "
                    f"(limits {limits})")
        for name, fault in (("maskrcnn_f32", "bn_local"),
                            ("graphsage_f32", "own_rows")):
            c, limits = r[name][fault], _zoo_mesh_limits(r[name])
            require(c["max_leaf_rel_l2"] > limits["max"],
                    f"zoo_2rank: the planted fault {fault} was not flagged: "
                    f"{c} (limits {limits})")
        for name, per_step in (("maskrcnn_train", MASKRCNN_STEP_LAUNCHES),
                               ("dlrm_train", {})):
            t = r[name]
            require(all(math.isfinite(x) for x in t["losses"]),
                    f"zoo_2rank {name}: losses {t['losses']}")
            if on_card:
                _require_no_launches(f"zoo_2rank {name}", t, per_step)
            for k in launches:
                launches[k] += t["launches"][k]
    out["launches"] = launches
    emit("zoo_2rank_launches", launches=launches)
    return out


# ---------------------------------------------------------------- runtime --

@dataclasses.dataclass(frozen=True)
class RuntimeLoad:
    """The runtime phase.  `ServingRuntime` at `serve_model` answering one
    /v1/generate of `new_tokens` over a `prompt`-token prompt; then the
    command `AIRuntime.get_runnable_command` gives for this script, with
    `--nproc-per-node 1` and the load's deadline: one rank of
    `recipes.llama_lora_finetune.build` at its defaults (tpu_1b, rank 16,
    B=8, S=2048, f32 base) plus `argv`, AdamW at `lr` with no warmup,
    `warmup` steps then `steps` measured ones on one repeated batch."""
    device: str = "cuda"
    serve_model: str = "tpu_1b"
    prompt: int = 64
    new_tokens: int = 8
    argv: tuple = ()
    lr: float = 3e-3
    warmup: int = 1
    steps: int = 2
    deadline_s: float = 300.0


RUNTIME_LOAD = RuntimeLoad()
# the CPU rehearsal at `tiny`
RUNTIME_REHEARSAL = RuntimeLoad(
    device="cpu", serve_model="tiny", prompt=8, new_tokens=4,
    argv=("--model", "tiny", "--seq-len", "64", "--batch", "4"), lr=1e-2,
    deadline_s=240.0)


def runtime_rank(load: RuntimeLoad, out_path: str) -> int:
    """The rank the runtime phase starts through the port's launcher: the
    LoRA recipe's trainer, built where `TIK_COMPILE_CACHE_DIR` points the
    kernel build (`Trainer.__init__` applies it), a warm-up step (whose
    first flash launch loads, or builds, the libraries), then
    `build_all()` (which must find every library) and the measured steps,
    the launch counts zeroed just before them and read just after; writes
    `out_path`.  `fit` books every build to the goodput ledger's compile
    bucket from its first step on."""
    import torch

    from cloudtik_tpu_torch.ops import _kernels
    from cloudtik_tpu_torch.recipes import llama_lora_finetune as R
    from cloudtik_tpu_torch.telemetry import goodput
    from cloudtik_tpu_torch.train.optim import OptimizerConfig

    started = time.time()
    on_card = load.device == "cuda"
    if not on_card:
        torch.set_num_threads(1)
    args = R.parser().parse_args(
        ["--device", load.device, "--log-every", "1", *load.argv])
    trainer, data, cfg, _, _ = R.build(args, OptimizerConfig(
        learning_rate=load.lr, warmup_steps=0, total_steps=1000))
    res = {"started_unix": started, "build_dir": str(_kernels.BUILD_DIR),
           "n_layers": cfg.n_layers, "model": args.model,
           "batch": args.batch, "seq": args.seq_len,
           "launch_env": {k: os.environ.get(k) for k in (
               "LOCAL_RANK", "LOCAL_WORLD_SIZE", "TIK_PROCESS_ID",
               "TIK_NUM_PROCESSES")}}
    trainer.init_state(torch.Generator(device=load.device).manual_seed(1))
    batch = itertools.repeat(next(data))
    warm = trainer.fit(batch, load.warmup)["history"]
    res["first_step_unix"] = time.time()
    res["warmup_launches"] = _launch_counts()
    res["built"] = sorted(_kernels.build_all())
    train = _train_measured(trainer, batch, 0, load.steps, on_card)
    train.pop("last")
    train.pop("history")
    train["losses"] = [h["loss"] for h in warm] + train["losses"]
    res.update(train)
    res["compile_s"] = goodput.LEDGER.total(goodput.BUCKET_COMPILE)
    res["pid"] = os.getpid()
    res["jax_modules"] = sorted(
        m for m, mod in sys.modules.items() if mod is not None
        and m.split(".")[0] in ("jax", "jaxlib", "cloudtik_tpu"))
    Path(out_path).write_text(json.dumps(res))
    return 0


def _without_nvcc(env: dict) -> dict:
    """`env` with no `nvcc` to be found: every PATH entry that holds one
    dropped and CUDA_HOME pointed at a directory that does not exist."""
    import shutil

    path = [d for d in env.get("PATH", "").split(os.pathsep)
            if d and shutil.which("nvcc", path=d) is None]
    return dict(env, PATH=os.pathsep.join(path),
                CUDA_HOME=os.path.join(env.get("TMPDIR", "/tmp"),
                                       "tik-no-cuda-home"))


def _runtime_serve(load: RuntimeLoad) -> dict:
    """`ServingRuntime` started and stopped as the delivery layer does,
    with the port's in-memory state client in its node context."""
    import numpy as np

    from cloudtik_tpu_torch.control.state import (InMemoryStateBackend,
                                                  StateClient)
    from cloudtik_tpu_torch.runtimes.discovery.runtime import ServiceRegistry
    from cloudtik_tpu_torch.runtimes.serving import runtime as SR

    state = StateClient(InMemoryStateBackend())
    context = {"is_head": True, "node_id": "head", "node_ip": "127.0.0.1",
               "state_client": state,
               "config": {"cluster_name": "smoke", "workspace_name": "card"}}
    registry = ServiceRegistry(state, "smoke", "card")
    runtime = SR.ServingRuntime({"model": load.serve_model, "port": 0,
                                 "device": load.device})
    t0 = time.perf_counter()
    runtime.node_services(context, "start")
    out = {"start_s": time.perf_counter() - t0}
    try:
        server = SR._servers[runtime.instance_key(context)]
        base = f"http://127.0.0.1:{server.port}"
        status, health = _http(f"{base}/healthz")
        require(status == 200 and health == {"status": "ok"},
                f"runtime: /healthz answered {status} {health}")
        listed = registry.query("serving")
        require([(s["port"], s["node_id"]) for s in listed]
                == [(server.port, "head")],
                f"runtime: discovery lists {listed}, expected the service "
                f"on its bound port {server.port}")
        backend = server.backends[0]
        prompt = np.random.default_rng(5).integers(
            0, backend.cfg.vocab_size, load.prompt).tolist()
        payload = {"tokens": [prompt], "max_new_tokens": load.new_tokens}
        t0 = time.perf_counter()
        status, got = _http(f"{base}/v1/generate", payload)
        out["request_ms"] = (time.perf_counter() - t0) * 1e3
        want = backend.endpoints["generate"](payload)
        require(status == 200 and got["tokens"] == want["tokens"],
                f"runtime: /v1/generate gave {status} {got}, the backend "
                f"in-process {want}")
        out.update(port=server.port, tokens=got["tokens"][0])
    finally:
        runtime.node_services(context, "stop")
    require(registry.query("serving") == [],
            "runtime: the service is still listed after stop")
    out["backend"] = backend.name
    return out


def phase_runtime(load: RuntimeLoad = RUNTIME_LOAD,
                  nvidia_smi: str = None) -> dict:
    """The port through its cluster runtimes (module docstring).  On the
    CPU no library is built: the copied cache holds an empty file under
    each library's name, which is all `build_all()` looks for."""
    import shutil
    import tempfile

    from cloudtik_tpu_torch.ops import _kernels
    from cloudtik_tpu_torch.runtimes import installer
    from cloudtik_tpu_torch.runtimes.ai.runtime import AIRuntime

    on_card = load.device == "cuda"
    _collect(on_card)
    root = Path(__file__).resolve().parent
    out = {"nvidia_smi": nvidia_smi, "load": dataclasses.asdict(load)}

    # ---- node_install with torch present: no installer call ----
    def refuse(*args, **kwargs):
        raise AssertionError(f"node_install called the installer: {args}")

    real_install, installer.install = installer.install, refuse
    try:
        AIRuntime({}).node_install({"is_head": True})
    finally:
        installer.install = real_install

    # ---- the serving runtime: counts zeroed just before, read just after;
    # generation's attention is the reference's einsums (prefill too), so
    # this path launches none of B1-B5 ----
    _zero_launch_counts()
    _zero_det_launch_counts()
    out["serve"] = _runtime_serve(load)
    serve_launches = {**_launch_counts(), **_det_launch_counts()}
    _collect(on_card)
    require(not any(serve_launches.values()),
            f"runtime: the serving path launched {serve_launches}, expected "
            "none")

    runtime = AIRuntime({"python": sys.executable})
    with tempfile.TemporaryDirectory(prefix="tik-runtime-") as tmp:
        tmp = Path(tmp)
        spec = tmp / "load.json"
        spec.write_text(json.dumps(dataclasses.asdict(load)))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(root)] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])

        def run(name: str, cache: Path, env: dict) -> dict:
            cmd = runtime.get_runnable_command(
                str(root / "chip_smoke.py"),
                ["--nproc-per-node", "1", "--deadline-s",
                 str(load.deadline_s)])
            cmd += ["--runtime-rank", str(spec), str(tmp / f"{name}.json")]
            log = tmp / f"{name}.log"
            t0 = time.time()
            with open(log, "w") as f:
                proc = subprocess.run(
                    cmd, cwd=str(root), stdout=f, stderr=subprocess.STDOUT,
                    env=dict(env, TIK_COMPILE_CACHE_DIR=str(cache)),
                    timeout=load.deadline_s + 60)
            result = tmp / f"{name}.json"
            return {"cmd": cmd, "rc": proc.returncode, "spawned_unix": t0,
                    "wall_s": time.time() - t0, "log": log.read_text(),
                    "rank": (json.loads(result.read_text())
                             if result.exists() else None)}

        # ---- the libraries this script built, copied to a fresh cache ----
        cache = tmp / "cache"
        cache.mkdir()
        for name in _kernels._SIGNATURES:
            lib = _kernels._target(name)
            if on_card:
                require(lib.exists(), f"runtime: {lib} was not built")
                shutil.copy2(lib, cache / lib.name)
            else:
                (cache / lib.name).touch()
        copied = sorted(p.name for p in cache.iterdir())
        warm = run("warm", cache, env)
        r = warm["rank"]
        require(warm["rc"] == 0 and r is not None,
                f"runtime: the launched rank failed (rc {warm['rc']}):\n"
                f"{warm['log'][-4000:]}")
        require(r["launch_env"] == {
            "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1", "TIK_PROCESS_ID": "0",
            "TIK_NUM_PROCESSES": "1"},
            f"runtime: the launcher gave the rank {r['launch_env']}")
        require(Path(r["build_dir"]).resolve() == cache.resolve(),
                f"runtime: the rank built into {r['build_dir']}, not the "
                f"cache {cache}")
        require(r["built"] == [] and r["compile_s"] == 0
                and sorted(p.name for p in cache.iterdir()) == copied,
                f"runtime: the rank built {r['built']} (compile bucket "
                f"{r['compile_s']} s; the cache now holds "
                f"{sorted(p.name for p in cache.iterdir())}) from a warm "
                "cache")
        require(all(math.isfinite(x) for x in r["losses"]),
                f"runtime: losses {r['losses']}")
        n = r["n_layers"]
        if on_card:
            require(r["launches_per_step"] == {
                "flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n},
                f"runtime: the rank's step launches "
                f"{r['launches_per_step']}, expected {n} of each kernel")

        # ---- a planted miss: a cold cache and no nvcc ----
        cold = tmp / "cold"
        cold.mkdir()
        miss = run("miss", cold, _without_nvcc(env))
        require(miss["rc"] != 0 and "KernelBuildError:" in miss["log"],
                f"runtime: a cold cache without nvcc did not fail with "
                f"KernelBuildError (rc {miss['rc']}):\n"
                f"{miss['log'][-4000:]}")
        require(not any(cold.glob("*.so")),
                f"runtime: the cold cache holds {list(cold.iterdir())}")
    launches = {k: serve_launches[k] + n for k, n in r["launches"].items()}
    out.update({
        "runnable_command": warm["cmd"],
        "rank": {k: r[k] for k in (
            "model", "batch", "seq", "n_layers", "launch_env", "build_dir",
            "built",
            "compile_s", "losses", "ms_per_step", "tokens_per_s", "mfu",
            "launches", "launches_per_step", "peak_mem_gb", "warmup_s")},
        "spawn_to_rank_start_s": r["started_unix"] - warm["spawned_unix"],
        "spawn_to_first_step_s": r["first_step_unix"] - warm["spawned_unix"],
        "rank_wall_s": warm["wall_s"],
        "miss": {"rc": miss["rc"], "wall_s": miss["wall_s"],
                 "error": [ln for ln in miss["log"].splitlines()
                           if "KernelBuildError:" in ln][-1]},
        "serve_launches": serve_launches, "launches": launches})
    emit("runtime", **out)
    return out


# ------------------------------------------------------------------ hosts --

_DETECT = """
import json, sys, time
t0 = time.perf_counter()
from cloudtik_tpu_torch.utils import resource_spec as R
resources = R.detect_node_resources(sys.argv[1], None, sys.argv[2])
ms = (time.perf_counter() - t0) * 1e3
with open("/proc/self/maps") as f:
    libcuda = "libcuda.so" in f.read()
print(json.dumps({"resources": resources, "ms": ms, "libcuda": libcuda,
                  "torch": "torch" in sys.modules,
                  "model_source": "proc" if R.driver_cards(sys.argv[2])
                  else "nvml"}), flush=True)
sys.stdin.read()
"""
# A bare CUDA context in a second process holds 523.5625 MiB of the card
# (tools/probe_torch_cuda_context.py on an NVIDIA H100 80GB HBM3, 700.00 W);
# the detection must hold none of it
CONTEXT_MIB = 64.0


def _detect(root: Path, env: dict, dev_root: str, proc_root: str,
            free_bytes=None) -> dict:
    """`_DETECT` in a fresh python3 with `env`: its JSON, its wall ms to
    the answer, and (where `free_bytes` reads the card's free memory) the
    MiB of device memory the process holds while it is still alive."""
    before = free_bytes() if free_bytes else None
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", _DETECT, dev_root, proc_root], cwd=str(root),
        env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        wall_ms = (time.perf_counter() - t0) * 1e3
        held = (before - free_bytes()) / 2**20 if free_bytes else None
        proc.stdin.close()
        err = proc.stderr.read()
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    require(rc == 0 and line, f"hosts: the detection failed: {err[-2000:]}")
    return dict(json.loads(line), wall_ms=wall_ms, device_mib=held)


def phase_hosts(expect_count: int, expect_name: str, dev_root: str = "/dev",
                proc_root: str = "/proc", free_bytes=None,
                nvidia_smi: str = None) -> dict:
    """This host as a cluster worker (module docstring): what the node
    agent would advertise, detected without the CUDA runtime, held to what
    torch sees in this process (`expect_count` cards of `expect_name`).
    `free_bytes` reads the card's free memory (None on the CPU)."""
    from cloudtik_tpu_torch.launch.distributor import default_nproc_per_node
    from cloudtik_tpu_torch.utils.resource_spec import accelerator_key

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items() if k != "TIK_NODE_RESOURCES"}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    out = {"nvidia_smi": nvidia_smi, "expect": {
        "GPU": expect_count, "name": expect_name}}

    got = _detect(root, env, dev_root, proc_root, free_bytes)
    res = got["resources"]
    require(not got["torch"], "hosts: the detecting process loaded torch")
    require(got["device_mib"] is None or got["device_mib"] < CONTEXT_MIB,
            f"hosts: the card lost {got['device_mib']} MiB while the "
            f"detecting process lived: a CUDA context ({CONTEXT_MIB} MiB "
            "allowed)")
    require(res.get("GPU") == expect_count,
            f"hosts: detected {res.get('GPU')} cards, torch sees "
            f"{expect_count}")
    key = accelerator_key(expect_name)
    require(res.get(key) == 1.0 and sorted(res) == sorted(
        ["CPU", "memory", "GPU", key]),
            f"hosts: detected {res}, expected {key} beside CPU, memory and "
            "GPU")
    require(res["CPU"] >= 1 and res["memory"] > 0,
            f"hosts: CPU {res['CPU']}, memory {res['memory']}")

    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "cloudtik_tpu_torch.utils.resource_spec",
         "--dev-root", dev_root, "--proc-root", proc_root], cwd=str(root),
        env=env, capture_output=True, text=True, timeout=60)
    cli_ms = (time.perf_counter() - t0) * 1e3
    require(cli.returncode == 0 and json.loads(cli.stdout) == res,
            f"hosts: the command printed {cli.stdout!r} (rc "
            f"{cli.returncode}), the detection gave {res}")

    hidden = _detect(root, dict(env, CUDA_VISIBLE_DEVICES=""), dev_root,
                     proc_root)["resources"]
    require(sorted(hidden) == ["CPU", "memory"],
            f"hosts: CUDA_VISIBLE_DEVICES=\"\" still gave {hidden}")
    planted = {"CPU": 3.0, "GPU": 5.0, "custom": 1.0}
    override = _detect(root, dict(env, TIK_NODE_RESOURCES=json.dumps(
        planted)), dev_root, proc_root)["resources"]
    require(override == planted,
            f"hosts: TIK_NODE_RESOURCES={planted} came back as {override}")
    nproc = default_nproc_per_node()
    require(nproc == res["GPU"],
            f"hosts: the launcher's default --nproc-per-node is {nproc}, "
            f"the detection {res['GPU']}")
    out.update(resources=res, detect_ms=got["ms"],
               process_ms=got["wall_ms"], cli_ms=cli_ms,
               device_mib=got["device_mib"], libcuda_mapped=got["libcuda"],
               model_source=got["model_source"], nproc_per_node=nproc,
               seconds=time.perf_counter() - t_phase)
    emit("hosts", **out)
    return out


# ---------------------------------------------------------------- observe --

@dataclasses.dataclass(frozen=True)
class ObserveLoad:
    """The observe phase (module docstring).  (a) `ServingRuntime` with the
    engine at `model` (`slots` x `max_len`, the runtime's blocks of 16),
    the port's collector scraping every `scrape_s`; `requests` requests at
    once, request i a prompt of prompt_lens[i % 4] tokens asking for
    `new_tokens`; the burns read after `min_cycles` scrape cycles.  (b) The
    `serve-demand` policy (`sustain_cycles`) evaluated every `scrape_s`
    while `loop_clients` clients send the same prompts in a closed loop:
    `control_s` seconds without a fault, then with a `fault_s` latency at
    `serve.decode_step` until the demand rises (at most `fault_limit_s`).
    (c) The node exporter.  (d) `corpus_mb` MB of seeded text through the
    port's tokenizer; a `capture_steps`-step capture, then `train_model` at
    full width, B x S, bf16, for 1 + `capture_steps` steps on that file.
    `parts` picks the parts: "serve" is (a) and (b)."""
    device: str = "cuda"
    model: str = "tpu_1b"
    slots: int = 8
    max_len: int = 1024
    prompt_lens: tuple = (32, 128, 384, 700)
    requests: int = 16
    new_tokens: int = 16
    scrape_s: float = 0.25
    min_cycles: int = 31
    loop_clients: int = 16
    control_s: float = 5.0
    fault_s: float = 0.25
    fault_limit_s: float = 40.0
    sustain_cycles: int = 3
    corpus_mb: float = 4.0
    train_model: str = "tpu_1b"
    batch: int = 8
    seq: int = 2048
    capture_steps: int = 3
    parts: tuple = ("serve", "nodex", "capture")


OBSERVE_LOAD = ObserveLoad()
# the CPU rehearsal at `tiny`: a quarter of the lengths, a faster scrape
# (the SLO windows count cycles), a latency that still takes a queued
# request past the 2.5 s threshold with 8 new tokens
OBSERVE_REHEARSAL = ObserveLoad(
    device="cpu", model="tiny", max_len=256,
    prompt_lens=(8, 32, 96, 175), new_tokens=8, scrape_s=0.1,
    control_s=1.5, fault_s=0.5, fault_limit_s=30.0, parts=("serve", "nodex"))
# serve-ttft's objective (telemetry/slo.py default_slos)
TTFT_THRESHOLD_S = 2.5


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get_text(url: str, timeout: float = 30.0) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()


def _wait_http(url: str, proc, timeout_s: float = 60.0) -> None:
    """Wait until `url` answers 200; fail if `proc` exits first."""
    deadline = time.monotonic() + timeout_s
    while True:
        require(proc.poll() is None,
                f"observe: the process behind {url} exited {proc.returncode}")
        try:
            _get_text(url, timeout=2.0)
            return
        except (OSError, urllib.error.URLError):
            require(time.monotonic() < deadline,
                    f"observe: {url} did not answer in {timeout_s} s")
            time.sleep(0.05)


def _query(base: str, query: str) -> list:
    from urllib.parse import quote

    status, got = _http(f"{base}/api/v1/query?query={quote(query)}")
    require(status == 200 and got["status"] == "success",
            f"observe: /api/v1/query {query} gave {status} {got}")
    return got["data"]["result"]


def _query_sum(base: str, query: str) -> float:
    return sum(float(r["value"][1]) for r in _query(base, query))


def _slo_row(base: str, name: str = "serve-ttft") -> dict:
    status, got = _http(f"{base}/api/v1/slos")
    require(status == 200, f"observe: /api/v1/slos gave {status}")
    return next(r for r in got["data"]["slos"] if r["name"] == name)


class _ClosedLoop:
    """`n` clients, each posting its prompts to /v1/generate one after the
    other until stopped; every answer is counted, every failure kept."""

    def __init__(self, url: str, prompts: list, new_tokens: int, n: int):
        import threading

        self.url, self.prompts, self.new_tokens = url, prompts, new_tokens
        self.answered = 0
        self.failures = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._run, args=(i,),
                                          daemon=True) for i in range(n)]

    def _run(self, i: int) -> None:
        k = i
        while not self._stop.is_set():
            prompt = self.prompts[k % len(self.prompts)]
            k += len(self._threads)
            status, got = _http(self.url, {"tokens": [prompt],
                                           "max_new_tokens": self.new_tokens})
            with self._lock:
                if status == 200 and len(got["tokens"][0]) == self.new_tokens:
                    self.answered += 1
                else:
                    self.failures.append((status, got))

    def start(self) -> "_ClosedLoop":
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=600)
        require(not any(t.is_alive() for t in self._threads),
                "observe: a closed-loop client never returned")


def _observe_serve(load: ObserveLoad, root: Path, tmp: Path,
                   nodex_port: int) -> dict:
    """Parts (a) and (b): the serving runtime, the targets, the collector
    subprocess, the counts and burns, then the serve-demand policy without
    and with the planted fault."""
    import threading

    import numpy as np

    from cloudtik_tpu_torch.control.scaling_policies import (
        create_scaling_policy)
    from cloudtik_tpu_torch.control.state import (InMemoryStateBackend,
                                                  StateClient)
    from cloudtik_tpu_torch.faults import seams
    from cloudtik_tpu_torch.faults.plan import FaultPlan, FaultPoint
    from cloudtik_tpu_torch.runtimes.discovery.runtime import ServiceRegistry
    from cloudtik_tpu_torch.runtimes.discovery.sync import render_once
    from cloudtik_tpu_torch.runtimes.prometheus.collector import Collector
    from cloudtik_tpu_torch.runtimes.prometheus.runtime import (
        PrometheusRuntime)
    from cloudtik_tpu_torch.runtimes.serving import runtime as SR
    from cloudtik_tpu_torch.serve import reqlog
    from cloudtik_tpu_torch.serve.replicas import (ReplicaHeartbeat,
                                                   ReplicaRegistry)
    from cloudtik_tpu_torch.telemetry import events
    from cloudtik_tpu_torch.telemetry import instruments as ti

    serve_port, telemetry_port, collector_port = (
        _free_port(), _free_port(), _free_port())
    journal = tmp / "logs" / "events-torch.jsonl"
    serving = {"model": load.model, "engine": True, "slots": load.slots,
               "max_len": load.max_len, "device": load.device,
               "port": serve_port, "telemetry_port": telemetry_port,
               "events_path": str(journal)}
    config = {"cluster_name": "smoke", "workspace_name": "card",
              "telemetry_port": 0,
              "runtime": {"types": ["nodex", "serving"],
                          "nodex": {"port": nodex_port}, "serving": serving}}
    state = StateClient(InMemoryStateBackend())
    context = {"is_head": True, "node_id": "head", "node_ip": "127.0.0.1",
               "head_ip": "127.0.0.1", "state_client": state,
               "config": config, "conf_dir": str(tmp / "prometheus")}
    runtime = SR.ServingRuntime(serving)
    out = {"ports": {"serving": serve_port, "telemetry": telemetry_port,
                     "collector": collector_port, "nodex": nodex_port}}
    rng = np.random.default_rng(11)
    collector = None
    seams.disarm()
    # what this process recorded before (earlier phases' engines record in
    # the same registry): the collector must read that plus every answer
    held = {"ttft_count": sum(snap["count"]
                              for _, snap in ti.SERVE_TTFT.samples()),
            "ok": ti.SERVE_REQUESTS.value(result="ok")}
    out["held_before"] = held
    # the request ledger the port's `serve requests|explain` replay
    ledger = tmp / "logs" / "serve-requests.jsonl"
    reqlog.install(str(ledger))
    cli_env = dict(os.environ, TIK_HOME=str(tmp / "cli-home"),
                   PYTHONPATH=os.pathsep.join(
                       [str(root)] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p]))
    t0 = time.perf_counter()
    runtime.node_services(context, "start")
    out["start_s"] = time.perf_counter() - t0
    try:
        server = SR._servers[runtime.instance_key(context)]
        base = f"http://127.0.0.1:{server.port}"
        tbase = f"http://127.0.0.1:{telemetry_port}"
        engine = server.backends[0].engine
        vocab = server.backends[0].cfg.vocab_size
        prompts = [rng.integers(0, vocab, load.prompt_lens[i % 4]).tolist()
                   for i in range(load.requests)]
        require(events.installed() is not None
                and Path(events.installed().path) == journal,
                f"observe: the serving runtime's journal is "
                f"{events.installed()}, expected one at {journal}")
        # one answered request before the first scrape: the collector's
        # windows baseline every series at its first point (windows.py),
        # so the measured requests all count as new
        status, got = _http(f"{base}/v1/generate", {
            "tokens": [prompts[0]], "max_new_tokens": load.new_tokens})
        require(status == 200, f"observe: the warm-up request gave {status}")
        answered = 1
        text = _get_text(f"{tbase}/metrics")
        require("tik_serve_ttft_seconds_count" in text,
                "observe: the serving process's /metrics holds no "
                "tik_serve_ttft_seconds")

        # ---- the targets: the port's prometheus runtime and discovery ----
        PrometheusRuntime({"port": collector_port}).node_configure(context)
        conf_dir = Path(context["conf_dir"])
        targets = json.loads((conf_dir / "targets.json").read_text())
        jobs = {g["labels"]["job"]: g["targets"] for g in targets}
        home = tmp / "discovery"
        render_once(ServiceRegistry(state, "smoke", "card"), str(home))
        synced = json.loads((home / "prometheus" / "targets.json").read_text())
        synced_jobs = {g["labels"]["job"]: g["targets"] for g in synced}
        want = [f"127.0.0.1:{telemetry_port}"]
        require(jobs.get("serving-telemetry") == want
                and synced_jobs.get("serving-telemetry") == want
                and jobs.get("nodex") == [f"127.0.0.1:{nodex_port}"],
                f"observe: targets {jobs}, discovery's {synced_jobs}; "
                f"expected serving-telemetry at {want}")
        out["targets"] = {"runtime": jobs, "discovery": synced_jobs}
        out["declared_targets"] = _observe_declared(
            tmp / "prometheus-declared", serving, collector_port)

        # ---- the port's collector as its own process ----
        cmd = [sys.executable, "-m",
               "cloudtik_tpu_torch.runtimes.prometheus.collector",
               "--port", str(collector_port), "--conf-dir", str(conf_dir),
               "--scrape-interval", str(load.scrape_s)]
        env = dict(os.environ, TIK_HOME=str(tmp / "collector-home"),
                   PYTHONPATH=os.pathsep.join(
                       [str(root)] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p]))
        log = open(tmp / "collector.log", "w")
        collector = subprocess.Popen(cmd, cwd=str(root), env=env, stdout=log,
                                     stderr=subprocess.STDOUT)
        log.close()
        cbase = f"http://127.0.0.1:{collector_port}"
        t_collector = time.monotonic()
        _wait_http(f"{cbase}/-/ready", collector)
        deadline = time.monotonic() + 30
        while True:
            status, got = _http(f"{cbase}/api/v1/targets")
            health = {t["labels"]["job"]: t["health"]
                      for t in got["data"]["activeTargets"]}
            if health.get("serving-telemetry") == "up" \
                    and health.get("nodex") == "up":
                break
            require(time.monotonic() < deadline,
                    f"observe: the collector's targets {health}")
            time.sleep(load.scrape_s)
        out["target_health"] = health

        def counts() -> dict:
            """The collector's sums, less what the process held before."""
            sel = '{job="serving-telemetry"}'
            return {"ttft_count": _query_sum(
                        cbase, f"tik_serve_ttft_seconds_count{sel}")
                    - held["ttft_count"],
                    "ok": _query_sum(
                        cbase, 'tik_serve_requests_total{job="serving-'
                        'telemetry",result="ok"}') - held["ok"]}

        def settled(n: int) -> dict:
            """The counts once a scrape after the last answer has reached
            them (at most 10 s)."""
            deadline = time.monotonic() + 10
            while True:
                got = counts()
                if got == {"ttft_count": n, "ok": n} \
                        or time.monotonic() > deadline:
                    break
                time.sleep(load.scrape_s)
            require(got == {"ttft_count": n, "ok": n},
                    f"observe: the collector counts {got} more than the "
                    f"process held before ({held}); it answered {n}")
            return got

        # ---- (a) 16 requests at once ----
        results = [None] * load.requests

        def ask(i):
            results[i] = _http(f"{base}/v1/generate", {
                "tokens": [prompts[i]], "max_new_tokens": load.new_tokens})

        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(load.requests)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out["requests_s"] = time.perf_counter() - t0
        bad = [r for r in results if r[0] != 200
               or len(r[1]["tokens"][0]) != load.new_tokens]
        require(not bad, f"observe: failed requests {bad[:2]}")
        answered += load.requests
        out["after_requests"] = settled(answered)
        # >= min_cycles scrape cycles in the store: the TTFT count's
        # retained points, one a cycle since the first scrape
        while True:
            from urllib.parse import quote

            status, got = _http(
                f"{cbase}/api/v1/query_range?query=" + quote(
                    'tik_serve_ttft_seconds_count{job="serving-telemetry"}'))
            cycles = max([len(r["values"]) for r in got["data"]["result"]]
                         or [0])
            if cycles >= load.min_cycles:
                break
            require(time.monotonic() - t_collector < 120,
                    f"observe: {cycles} scrape cycles after 120 s")
            time.sleep(load.scrape_s)
        row = _slo_row(cbase)
        out["slo_after_requests"] = {k: row[k] for k in (
            "state", "burn_fast", "burn_slow", "budget_remaining")}
        out["cycles"] = cycles
        require(row["burn_fast"] is not None and row["burn_slow"] is not None
                and math.isfinite(row["burn_fast"])
                and math.isfinite(row["burn_slow"]),
                f"observe: serve-ttft burns {row} after {cycles} cycles")
        scrape = [ln for ln in _get_text(f"{cbase}/metrics").splitlines()
                  if ln.startswith("scrape_duration_seconds{")
                  and f'instance="127.0.0.1:{telemetry_port}"' in ln]
        require(len(scrape) == 1, f"observe: scrape durations {scrape}")
        out["scrape_ms"] = float(scrape[0].rsplit(" ", 1)[1]) * 1e3
        out["exposition_bytes"] = len(_get_text(f"{tbase}/metrics"))

        # ---- (b) the serve-demand policy over the live engine ----
        replicas = ReplicaRegistry(state)
        beat = ReplicaHeartbeat(
            replicas, "serving-0", base, slots=load.slots,
            stats_fn=engine.stats, period_s=load.scrape_s / 2)
        beat.start()
        policy = create_scaling_policy(
            "serve-demand", config, "127.0.0.1", state_client=state,
            scaling_config={"slo_url": cbase,
                            "sustain_cycles": load.sustain_cycles})
        seen = []
        fetch = policy.autoscaler.burn_source

        def recorded_burn():
            burn = fetch()
            seen.append(burn)
            return burn

        policy.autoscaler.burn_source = recorded_burn
        threshold = policy.autoscaler.config.burn_threshold

        def evaluate(until, stop_on_rise: bool) -> list:
            rows = []
            while time.monotonic() < until:
                t_eval = time.monotonic()
                n_seen = len(seen)
                demands = policy.get_scaling_state() \
                    .autoscaling_instructions["resource_demands"]
                burn = seen[-1] if len(seen) > n_seen else None
                slo = _slo_row(cbase)
                rows.append({
                    "t": t_eval, "demands": demands, "burn": burn,
                    "burning": burn is not None
                    and burn["fast"] > threshold
                    and burn["slow"] > threshold,
                    "queue": replicas.list_replicas()[0].queue_depth,
                    "slo": slo["state"]})
                # the policy (both burns above 1.0) and the SLO row (both
                # above 2.0) cross apart, in either order: stop once both
                # have
                if stop_on_rise and len(demands) > len(rows[0]["demands"]) \
                        and any(r["slo"] == "firing" for r in rows):
                    break
                time.sleep(max(load.scrape_s
                               - (time.monotonic() - t_eval), 0.0))
            return rows

        gen_url = f"{base}/v1/generate"
        try:
            baseline = policy.get_scaling_state() \
                .autoscaling_instructions["resource_demands"]
            require(baseline == [{"GPU": 1}],
                    f"observe: the policy's demands before any load "
                    f"{baseline}, expected one {{'GPU': 1}}")
            # the negative control: the same closed loop, no fault
            loop = _ClosedLoop(gen_url, prompts, load.new_tokens,
                               load.loop_clients).start()
            control = evaluate(time.monotonic() + load.control_s, False)
            loop.stop()
            answered += loop.answered
            require(not loop.failures,
                    f"observe: control failures {loop.failures[:2]}")
            require(all(r["demands"] == baseline for r in control),
                    f"observe: the policy raised its demand without a "
                    f"fault: {[r['demands'] for r in control]}")
            require(any(r["queue"] > 0 for r in control),
                    "observe: the control never held a backlog, so it "
                    "could not have scaled")
            out["control"] = {
                "evaluations": len(control), "answered": loop.answered,
                "max_queue": max(r["queue"] for r in control),
                "max_burn": max([max(r["burn"]["fast"], r["burn"]["slow"])
                                 for r in control if r["burn"]] or [None]),
                "slo_states": sorted({r["slo"] for r in control})}
            out["after_control"] = settled(answered)
            before = _get_text(f"{tbase}/metrics")

            # the planted fault: every decode step waits fault_s
            plan = FaultPlan([FaultPoint(
                "serve.decode_step", "latency", times=0,
                args={"seconds": load.fault_s})], seed=0, name="observe")
            seams.arm(plan)
            t_fault = time.monotonic()
            loop = _ClosedLoop(gen_url, prompts, load.new_tokens,
                               load.loop_clients).start()
            try:
                fault = evaluate(t_fault + load.fault_limit_s, True)
            finally:
                seams.disarm()
                loop.stop()
            answered += loop.answered
            require(not loop.failures,
                    f"observe: fault-run failures {loop.failures[:2]}")
        finally:
            beat.stop(deregister=True)
        rise = next((i for i, r in enumerate(fault)
                     if len(r["demands"]) > len(baseline)), None)
        first_burn = next((i for i, r in enumerate(fault) if r["burning"]),
                          None)
        firing = next((i for i, r in enumerate(fault)
                       if r["slo"] == "firing"), None)
        out["fault"] = {
            "seconds": load.fault_s, "decode_steps_delayed": len(plan.trace),
            "evaluations": len(fault), "answered": loop.answered,
            "first_firing_eval": firing, "first_burning_eval": first_burn,
            "rise_eval": rise,
            "firing_after_s": None if firing is None
            else fault[firing]["t"] - t_fault,
            "rise_after_s": None if rise is None
            else fault[rise]["t"] - t_fault,
            "demands": fault[-1]["demands"],
            "burn_at_rise": None if rise is None else fault[rise]["burn"]}
        require(firing is not None,
                f"observe: serve-ttft never turned firing under the fault "
                f"({len(fault)} evaluations, last burn {fault[-1]['burn']})")
        require(rise is not None and fault[rise]["demands"]
                == [{"GPU": 1}] * (len(baseline) + 1),
                f"observe: the policy's demands under the fault "
                f"{fault[-1]['demands']}")
        require(first_burn is not None
                and rise - first_burn <= load.sustain_cycles,
                f"observe: the demand rose at evaluation {rise}, the burn "
                f"first crossed at {first_burn} (sustain cycles "
                f"{load.sustain_cycles})")
        out["after_fault"] = settled(answered)
        after = _get_text(f"{tbase}/metrics")

        def ttft_buckets(text):
            got = {}
            for ln in text.splitlines():
                if ln.startswith("tik_serve_ttft_seconds_bucket{"):
                    le = ln.split('le="', 1)[1].split('"', 1)[0]
                    got[le] = float(ln.rsplit(" ", 1)[1])
            return got

        b0, b1 = ttft_buckets(before), ttft_buckets(after)
        le = next(k for k in b1 if k != "+Inf"
                  and float(k) == TTFT_THRESHOLD_S)
        total = b1["+Inf"] - b0["+Inf"]
        out["fault"]["ttft_past_threshold"] = [
            total - (b1[le] - b0[le]), total]

        # ---- F3 through the port's CLI: one traced request's spans in
        # the stitched cluster trace ----
        traced = _traced_request(f"{base}/v1/generate", prompts[1],
                                 load.new_tokens)
        out["trace"] = _observe_trace(root, cli_env, conf_dir,
                                      telemetry_port, traced)

        # ---- the SLO evaluation's cost: the port's Collector in this
        # process over the same targets, the engine idle ----
        probe = Collector(str(conf_dir))
        eval_ms = []
        for _ in range(load.min_cycles):
            probe.scrape_once()
            samples = probe.alert_samples()
            now = time.time()
            probe.windows.ingest(samples, now)
            t0 = time.perf_counter()
            probe.slos.evaluate(probe.windows, now)
            eval_ms.append((time.perf_counter() - t0) * 1e3)
        out["slo_eval_ms"] = sorted(eval_ms)[len(eval_ms) // 2]
        out["slo_eval_samples"] = len(samples)
    finally:
        seams.disarm()
        if collector is not None:
            collector.terminate()
            collector.wait(timeout=30)
        runtime.node_services(context, "stop")
        reqlog.uninstall()
    left = [s["name"] for s in ServiceRegistry(state, "smoke", "card").query()]
    require(not left, f"observe: {left} still listed after stop")
    require(events.installed() is None,
            "observe: the port's journal is still installed after stop")
    records, torn = events.read_file(str(journal))
    names = [r["name"] for r in records]
    out["journal"] = {"path": str(journal), "records": len(records),
                      "torn": torn,
                      "admissions": names.count("tik_serve_admission"),
                      "faults": names.count("tik_fault_fired")}
    require(names.count("tik_serve_admission") >= answered
            and names.count("tik_fault_fired") == len(plan.trace),
            f"observe: the port's journal holds {out['journal']}, "
            f"{answered} requests answered and {len(plan.trace)} faults fired")
    fired, _ = events.read_file(str(tmp / "collector-home" / "logs"
                                    / "events.jsonl"))
    out["collector_alerts"] = [r.get("rule") for r in fired
                               if r["name"] == "tik_alert_fired"]
    require("slo:serve-ttft" in out["collector_alerts"],
            f"observe: the collector journaled {out['collector_alerts']}")
    out["answered"] = answered
    # every answer, the traced request's too
    out["records"] = _observe_records(root, cli_env, ledger, journal,
                                      traced, answered + 1,
                                      names.count("tik_serve_admission"))
    return out


# `import jax` and the JAX package raise in the port CLI's processes: a
# card host has neither
_NO_JAX = ("import runpy, sys\n"
           "sys.modules['jax'] = None\n"
           "sys.modules['cloudtik_tpu'] = None\n"
           "sys.argv = ['tik'] + sys.argv[1:]\n"
           "runpy.run_module('cloudtik_tpu_torch.scripts.cli', "
           "run_name='__main__')\n")


def _port_cli(root: Path, env: dict, *args: str) -> tuple:
    """(stdout, seconds) of `python -m cloudtik_tpu_torch.scripts.cli
    *args` in a process where `import jax` raises; fails the phase on an
    exit other than 0."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, *args],
                          cwd=str(root), env=env, capture_output=True,
                          text=True, timeout=300)
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"observe: `tik {' '.join(args)}` exited {proc.returncode}: "
            f"{proc.stderr[-2000:]}")
    return proc.stdout, seconds


def _traced_request(url: str, prompt: list, new_tokens: int) -> dict:
    """One request whose answer's headers name its ledger record and its
    trace: {"request_id", "traceparent", "trace_id"}."""
    req = urllib.request.Request(
        url, data=json.dumps({"tokens": [prompt],
                              "max_new_tokens": new_tokens}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        got = json.loads(resp.read())
        traced = {"request_id": resp.headers.get("x-tik-request-id"),
                  "traceparent": resp.headers.get("x-tik-traceparent")}
        require(resp.status == 200
                and len(got["tokens"][0]) == new_tokens,
                f"observe: the traced request gave {resp.status}")
    require(traced["request_id"] and traced["traceparent"],
            f"observe: the traced request's headers {traced}")
    traced["trace_id"] = traced["traceparent"].split("-")[1]
    return traced


def _observe_trace(root: Path, env: dict, conf_dir: Path,
                   telemetry_port: int, traced: dict) -> dict:
    """`cluster trace export --trace-id` over the phase's targets (into
    `trace-<id>.json` beside them) holds the traced request's serve.*
    spans under its one trace id in the serving process's lane, and
    `cluster trace summary` lists it."""
    trace_id = traced["trace_id"]
    path = conf_dir / f"trace-{trace_id}.json"
    _, export_s = _port_cli(root, env, "cluster", "trace", "export",
                            "--conf-dir", str(conf_dir),
                            "--trace-id", trace_id, "-o", str(path))
    trace = json.loads(path.read_text())
    lanes = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"]
             if e.get("ph") == "M"}
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    lane = f"serving-telemetry (127.0.0.1:{telemetry_port})"
    names = sorted({e["name"] for e in spans if lanes.get(e["pid"]) == lane})
    want = ("serve.enqueue", "serve.prefill", "serve.decode")
    require({(e.get("args") or {}).get("trace_id") for e in spans}
            == {trace_id} and set(want) <= set(names),
            f"observe: the stitched trace of {trace_id} holds "
            f"{[(lanes.get(e['pid']), e['name']) for e in spans][:20]}; "
            f"expected {want} in the lane {lane}")
    text, summary_s = _port_cli(root, env, "cluster", "trace", "summary",
                                "--conf-dir", str(conf_dir),
                                "--trace-id", trace_id)
    rows = [ln.split() for ln in text.splitlines()
            if ln.startswith(trace_id)]
    require(len(rows) == 1 and int(rows[0][1]) == len(spans),
            f"observe: `cluster trace summary` printed {text!r} for "
            f"{trace_id} ({len(spans)} spans exported)")
    return {"trace_id": trace_id, "lanes": sorted(lanes.values()),
            "spans": len(spans), "names": names, "export_s": export_s,
            "summary_s": summary_s}


def _observe_records(root: Path, env: dict, ledger: Path, journal: Path,
                     traced: dict, answered: int, admissions: int) -> dict:
    """The port's `serve requests --stats` counts every answered request
    in the phase's ledger, `serve explain` finds the traced one, and
    `events dump` the journal's admissions (the traced request's one
    under its trace id)."""
    text, requests_s = _port_cli(root, env, "serve", "requests", "--stats",
                                 "--json", "--path", str(ledger))
    stats = json.loads(text)
    require(stats["count"] == answered
            and stats["finish"] == {"done": answered},
            f"observe: `serve requests --stats` counts {stats['count']} "
            f"({stats['finish']}); the phase answered {answered}")
    text, _ = _port_cli(root, env, "serve", "explain",
                        traced["request_id"], "--path",
                        str(ledger.parent / "no-router.jsonl"),
                        "--reqlog", str(ledger), "--json")
    built = json.loads(text)
    finishing = built.get("finishing") or {}
    require(str(finishing.get("request_id")) == traced["request_id"]
            and traced["trace_id"] in str(finishing.get("traceparent")),
            f"observe: `serve explain {traced['request_id']}` found "
            f"{finishing}")
    text, _ = _port_cli(root, env, "events", "dump", "--json", "--path",
                        str(journal))
    dumped = [r["name"] for r in json.loads(text)]
    text, _ = _port_cli(root, env, "events", "dump", "--json", "--path",
                        str(journal), "--trace-id", traced["trace_id"])
    in_trace = [r["name"] for r in json.loads(text)]
    dumped_admissions = dumped.count("tik_serve_admission")
    require(dumped_admissions == admissions >= answered
            and in_trace.count("tik_serve_admission") == 1,
            f"observe: `events dump` gave {dumped_admissions} admissions "
            f"(the journal holds {admissions}, {answered} answered), "
            f"{in_trace} under {traced['trace_id']}")
    return {"ledger_count": stats["count"], "requests_s": requests_s,
            "explain_phases": {k: v for k, v in built["phases"].items()
                               if v is not None},
            "admissions": admissions, "trace_events": in_trace}


def _observe_declared(conf: Path, serving: dict, port: int) -> dict:
    """F4: the port's `PrometheusRuntime.node_configure` for a cluster
    declaring the port's `serving` beside `consul`, `spark` and `grafana`
    renders every http service those runtimes declare."""
    from cloudtik_tpu_torch.runtimes.prometheus.runtime import (
        PrometheusRuntime)
    from cloudtik_tpu_torch.runtimes.registry import iter_runtimes

    config = {"cluster_name": "smoke", "telemetry_port": 0, "runtime": {
        "types": ["serving", "consul", "spark", "grafana"],
        "serving": serving}}
    PrometheusRuntime({"port": port}).node_configure({
        "is_head": True, "config": config, "head_ip": "127.0.0.1",
        "conf_dir": str(conf)})
    jobs = sorted(g["labels"]["job"] for g in json.loads(
        (conf / "targets.json").read_text()))
    want = sorted(name for rt in iter_runtimes(config)
                  for name, svc in (rt.get_runtime_services(
                      config, "127.0.0.1") or {}).items()
                  if svc.get("protocol") == "http")
    require(jobs == want and {"serving", "serving-telemetry", "consul",
                              "spark-ui", "grafana"} <= set(jobs)
            and (conf / "prometheus.yml").is_file(),
            f"observe: a cluster declaring serving, consul, spark and "
            f"grafana renders the jobs {jobs}; expected {want}")
    return {"jobs": jobs}


def _observe_nodex(port: int, proc) -> dict:
    """Part (c): the exporter the nodex runtime's command started."""
    from cloudtik_tpu_torch.telemetry import names

    _wait_http(f"http://127.0.0.1:{port}/metrics", proc)
    want = ("tik_node_cpu_percent", "tik_node_memory_percent",
            "tik_node_disk_percent", "tik_node_net_sent_bytes",
            "tik_node_net_recv_bytes")
    deadline = time.monotonic() + 30
    while True:
        t0 = time.perf_counter()
        text = _get_text(f"http://127.0.0.1:{port}/metrics")
        ms = (time.perf_counter() - t0) * 1e3
        values = {}
        for ln in text.splitlines():
            if ln and not ln.startswith("#"):
                name = ln.split("{", 1)[0].split(" ", 1)[0]
                values.setdefault(name, float(ln.rsplit(" ", 1)[1]))
        if all(n in values for n in want):
            break
        require(time.monotonic() < deadline,
                f"observe: the exporter serves {sorted(values)}")
        time.sleep(0.2)
    base = {re.sub(r"_(bucket|sum|count)$", "", n) for n in values}
    unknown = sorted(n for n in base if n not in names.METRICS)
    require(not unknown, f"observe: the exporter serves names outside the "
                         f"port's catalog: {unknown}")
    require(0.0 <= values["tik_node_memory_percent"] <= 100.0
            and 0.0 <= values["tik_node_disk_percent"] <= 100.0,
            f"observe: node gauges {values}")
    return {"gauges": {n: values[n] for n in want}, "names": len(base),
            "metrics_ms": ms}


def _observe_capture(load: ObserveLoad, tmp: Path) -> dict:
    """Part (d): the corpus through the port's tokenizer, a requested
    capture of a fit on that file, the profiler runtime serving it."""
    import numpy as np
    import torch

    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.runtimes.profiler.runtime import ProfilerRuntime
    from cloudtik_tpu_torch.telemetry import stepprof
    from cloudtik_tpu_torch.train import data as TD
    from cloudtik_tpu_torch.train import tokenizer as TK
    from cloudtik_tpu_torch.train.optim import OptimizerConfig
    from cloudtik_tpu_torch.train.trainer import (
        Trainer, TrainerConfig, transformer_spec)

    on_card = load.device == "cuda"
    rng = np.random.default_rng(17)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = ["".join(rng.choice(letters, n)) for n in
             rng.integers(2, 10, 4096)]
    paragraphs, size = [], 0
    while size < load.corpus_mb * 1e6:
        para = " ".join(words[i] for i in rng.integers(0, len(words), 200))
        paragraphs.append(para)
        size += len(para) + 2
    text_path = tmp / "corpus.txt"
    text_path.write_text("\n\n".join(paragraphs))
    corpus = tmp / "corpus.npy"
    t0 = time.perf_counter()
    n_tokens = TK.encode_corpus(str(text_path), str(corpus))
    encode_s = time.perf_counter() - t0
    text_mb = text_path.stat().st_size / 1e6
    require(n_tokens == len(np.load(corpus, mmap_mode="r"))
            and n_tokens >= (1 + load.capture_steps) * load.batch
            * (load.seq + 1),
            f"observe: the corpus holds {n_tokens} tokens")

    cfg = T.config(load.train_model, max_seq_len=load.seq,
                   param_dtype=torch.bfloat16)
    trainer = Trainer(transformer_spec(cfg), TrainerConfig(
        global_batch_size=load.batch, seq_len=load.seq,
        optimizer=OptimizerConfig(moment_dtype="bfloat16"), log_every=1),
        device=load.device)
    trainer.init_state(torch.Generator(device=load.device).manual_seed(0))
    profiles = tmp / "profiles"
    run = profiles / "observe-run"
    request = tmp / "profile-request.json"
    stepprof.request_capture(load.capture_steps, str(run), path=str(request))
    stops = []
    real_stop = stepprof.ProfileCapture.stop

    def timed_stop(self, sync_leaf=None):
        t0 = time.perf_counter()
        was = self.active
        real_stop(self, sync_leaf)
        if was:
            stops.append(time.perf_counter() - t0)

    was_env = os.environ.get(stepprof.REQUEST_ENV)
    os.environ[stepprof.REQUEST_ENV] = str(request)
    stepprof.ProfileCapture.stop = timed_stop
    # ---- the fit: counts zeroed just before, read just after ----
    _zero_launch_counts()
    try:
        t0 = time.perf_counter()
        history = trainer.fit(TD.tokenized_file_batches(
            str(corpus), load.batch, load.seq, seed=0),
            1 + load.capture_steps)["history"]
        fit_s = time.perf_counter() - t0
    finally:
        launches = _launch_counts()
        stepprof.ProfileCapture.stop = real_stop
        if was_env is None:
            os.environ.pop(stepprof.REQUEST_ENV, None)
        else:
            os.environ[stepprof.REQUEST_ENV] = was_env
    del trainer
    _collect(on_card)
    trace = run / "trace.json"
    require(trace.exists() and len(stops) == 1 and not request.exists(),
            f"observe: capture stops {stops}, trace {trace.exists()}, "
            f"request left {request.exists()}")
    raw = trace.read_bytes()
    kernels = {k: 0 for k in FLASH_KERNELS}
    for e in json.loads(raw)["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            for k in kernels:
                if k in e.get("name", ""):
                    kernels[k] += 1
    n = cfg.n_layers if on_card else 0
    require(kernels == {k: n * load.capture_steps for k in kernels},
            f"observe: the trace holds {kernels}, expected "
            f"{n * load.capture_steps} of each ({n} a captured step)")
    require(launches == {k: n * (1 + load.capture_steps) for k in launches},
            f"observe: the fit launched {launches}")
    require(all(math.isfinite(e["loss"]) for e in history),
            f"observe: losses {[e['loss'] for e in history]}")

    # ---- the profiler runtime's command serves the trace ----
    port = _free_port()
    rt = ProfilerRuntime({"profile_dir": str(profiles), "port": port})
    cmd = rt.service_command({"is_head": True})
    log = open(tmp / "profiler.log", "w")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    log.close()
    try:
        url = f"http://127.0.0.1:{port}/observe-run/trace.json"
        _wait_http(f"http://127.0.0.1:{port}/", proc)
        t0 = time.perf_counter()
        with urllib.request.urlopen(url, timeout=60) as resp:
            served = resp.read()
        serve_s = time.perf_counter() - t0
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    require(served == raw, f"observe: the profiler served {len(served)} "
                           f"bytes, the trace holds {len(raw)}")
    require(rt.get_processes()[0][0] in cmd,
            f"observe: get_processes {rt.get_processes()} names none of "
            f"{cmd}")
    return {"corpus_mb": text_mb, "tokens": n_tokens, "encode_s": encode_s,
            "tokenizer_mb_s": text_mb / encode_s,
            "fit_s": fit_s, "losses": [e["loss"] for e in history],
            "launches": launches, "trace_kernels": kernels,
            "trace_mb": len(raw) / 1e6, "capture_stop_s": stops[0],
            "profiler_cmd": cmd, "profiler_serve_s": serve_s}


def phase_observe(load: ObserveLoad = OBSERVE_LOAD,
                  nvidia_smi: str = None) -> dict:
    """The port's serving metrics on the cluster's scrape path (module
    docstring).  The flash launch counts are zeroed just before the serving
    parts and read just after (generation's attention is einsums: none),
    and zeroed and read around the capture's fit."""
    import shutil
    import tempfile

    from cloudtik_tpu_torch.runtimes.nodex.runtime import NodexRuntime

    on_card = load.device == "cuda"
    root = Path(__file__).resolve().parent
    out = {"nvidia_smi": nvidia_smi, "load": dataclasses.asdict(load)}
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="tik-observe-"))
    nodex = None
    try:
        # ---- (c) first, so the collector scrapes the exporter too ----
        nodex_port = _free_port()
        nodex_cmd = NodexRuntime({"port": nodex_port, "interval_s": 1.0}) \
            .service_command({"is_head": True})
        if "nodex" in load.parts:
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                [str(root)] + [p for p in os.environ.get(
                    "PYTHONPATH", "").split(os.pathsep) if p]))
            log = open(tmp / "nodex.log", "w")
            nodex = subprocess.Popen(nodex_cmd, cwd=str(root), env=env,
                                     stdout=log, stderr=subprocess.STDOUT)
            log.close()
            out["nodex"] = _observe_nodex(nodex_port, nodex)
        if "serve" in load.parts:
            _collect(on_card)
            _zero_launch_counts()
            _zero_det_launch_counts()
            out["serve"] = _observe_serve(load, root, tmp, nodex_port)
            serve_launches = {**_launch_counts(), **_det_launch_counts()}
            _collect(on_card)
            require(not any(serve_launches.values()),
                    f"observe: the serving path launched {serve_launches}, "
                    "expected none")
            out["serve_launches"] = serve_launches
        if "capture" in load.parts:
            out["capture"] = _observe_capture(load, tmp)
    finally:
        if nodex is not None:
            nodex.terminate()
            nodex.wait(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = out.get("capture", {}).get(
        "launches", {k: 0 for k in _launch_counts()})
    out["seconds"] = time.perf_counter() - t_phase
    # the numbers a reader of the line wants first, beside the card's name
    # and power limit
    serve, cap = out.get("serve", {}), out.get("capture", {})
    out["timing"] = {"scrape_ms": serve.get("scrape_ms"),
                     "slo_eval_ms": serve.get("slo_eval_ms"),
                     "capture_stop_s": cap.get("capture_stop_s"),
                     "trace_mb": cap.get("trace_mb"),
                     "tokenizer_mb_s": cap.get("tokenizer_mb_s")}
    emit("observe", **out)
    return out


# ---------------------------------------------------------------- control --

@dataclasses.dataclass(frozen=True)
class ControlLoad:
    """The control phase (module docstring).  The port's `ClusterController`
    ticking every `update_interval_s` over the virtual provider, an idle
    timeout of `idle_timeout_s`; the worker's start command runs `rank`
    (the runtime phase's rank) through the AI runtime's command."""
    rank: RuntimeLoad = RuntimeLoad(steps=1, deadline_s=120.0)
    update_interval_s: float = 0.5
    idle_timeout_s: float = 40.0


CONTROL_LOAD = ControlLoad()
# the CPU rehearsal at `tiny`
CONTROL_REHEARSAL = ControlLoad(
    rank=dataclasses.replace(RUNTIME_REHEARSAL, steps=1, deadline_s=60.0),
    update_interval_s=0.25, idle_timeout_s=15.0)
# controller ticks that must pass without a launch before the job; the
# longest any other wait of the phase may take
CONTROL_QUIET_TICKS = 4
CONTROL_WAIT_S = 120.0

# Every python process the control phase starts runs this first (a
# directory holding it leads PYTHONPATH): `import jax` and the JAX package
# raise, as on a card host, and the process leaves its pid in a log
_SITE_NO_JAX = """import json, os, sys
sys.modules["jax"] = None
sys.modules["cloudtik_tpu"] = None
_log = os.environ.get("TIK_SMOKE_PROCESS_LOG")
if _log:
    with open(_log, "a") as _f:
        _f.write(json.dumps({"pid": os.getpid(),
                             "argv": sys.orig_argv[:4]}) + "\\n")
"""
# The rehearsal's sampler: the native sampler's own samples with the host's
# cpu_percent read as 0.  On a CPU other tests keep busy, the host never
# reads idle (the controller counts a host above 15% as active), so the
# idle timeout could not fire; on the card the real sampler reports.
_QUIET_SAMPLER = """#!{python}
import json, os, subprocess, sys
args = sys.argv[1:]
if "--fate-parent" in args:
    args[args.index("--fate-parent") + 1] = str(os.getpid())
proc = subprocess.Popen([{binary!r}] + args, stdout=subprocess.PIPE,
                        text=True)
for line in proc.stdout:
    sample = json.loads(line)
    sample["cpu_percent"] = 0.0
    print(json.dumps(sample), flush=True)
"""
_SAMPLER_WARNING = "native host agent unavailable; using psutil"


def _wait(what: str, predicate, timeout_s: float, poll_s: float = 0.05,
          phase: str = "control"):
    """predicate()'s first truthy value, polled until `timeout_s`."""
    deadline = time.time() + timeout_s
    while True:
        got = predicate()
        if got:
            return got
        require(time.time() < deadline,
                f"{phase}: no {what} within {timeout_s} s")
        time.sleep(poll_s)


def _maps_hold(pid: int, names: tuple) -> list:
    """Which of `names` (library names) process `pid` maps."""
    with open(f"/proc/{pid}/maps") as f:
        maps = f.read()
    return [n for n in names if n in maps]


def _group_alive(pgid: int) -> list:
    """Pids of live (not zombie) processes in process group `pgid`."""
    alive = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if int(fields[2]) == pgid and fields[0] != "Z":
            alive.append(int(entry))
    return alive


def _stop_pidfile(path) -> None:
    """SIGTERM to the port's process whose pid `path` holds, where it is
    still alive (a pid of a process long gone may name another by now)."""
    import signal

    if path is None:
        return
    try:
        pid = int(path.read_text())
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            ours = b"cloudtik_tpu_torch" in f.read()
    except (OSError, ValueError):
        return
    if ours:
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGTERM)


def _reap(pid: int, timeout_s: float) -> None:
    """Wait for child `pid` (a process this one started) to be gone."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        try:
            done, _ = os.waitpid(pid, os.WNOHANG)
        except ChildProcessError:
            return
        if done:
            return
        time.sleep(0.05)


def _head_env(site: Path, home: Path, processes: Path, tmp: Path,
              on_card: bool) -> None:
    """The environment of a control-plane phase, set in this process (the
    head) and inherited by every process it starts: the guard's directory
    first on PYTHONPATH, `home` as TIK_HOME, the native sampler, and the
    kernel cache (the built libraries on the card; on the CPU an empty
    file under each name, all `build_all()` looks for)."""
    from cloudtik_tpu_torch.ops import _kernels

    site.mkdir()
    (site / "sitecustomize.py").write_text(_SITE_NO_JAX)
    os.environ.pop("TIK_NODE_RESOURCES", None)
    os.environ.update({
        "PYTHONPATH": os.pathsep.join(
            [str(site), str(Path(__file__).resolve().parent)]
            + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
               if p]),
        "TIK_HOME": str(home), "TIK_NATIVE_AGENT": "1",
        "TIK_SMOKE_PROCESS_LOG": str(processes)})
    if on_card:
        os.environ["TIK_COMPILE_CACHE_DIR"] = str(_kernels.BUILD_DIR)
    else:
        cache = tmp / "cache"
        cache.mkdir()
        for name in _kernels._SIGNATURES:
            (cache / _kernels._target(name).name).touch()
        os.environ["TIK_COMPILE_CACHE_DIR"] = str(cache)


def _native_head(home: Path, on_card: bool, phase: str) -> tuple:
    """(the started native state server, seconds of each g++ build): the
    state server and the host sampler built in parallel under TIK_HOME
    (the agent finds its sampler there); on the CPU the sampler is wrapped
    by `_QUIET_SAMPLER`.  TIK_STATE_PORT is set to the server's port."""
    import threading

    from cloudtik_tpu_torch import native

    built = {}

    def build(name, fn):
        t0 = time.perf_counter()
        built[name] = (fn(), time.perf_counter() - t0)

    threads = [threading.Thread(target=build, args=a) for a in (
        ("state_server", native.ensure_built),
        ("host_agent", native.ensure_agent_built))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    require(all(b for b, _ in built.values()),
            f"{phase}: no C++ compiler built the native parts {built}")
    if not on_card:
        real = home / "native" / "tik-host-agent.real"
        os.replace(native.agent_binary_path(), real)
        quiet = Path(native.agent_binary_path())
        quiet.write_text(_QUIET_SAMPLER.format(
            python=sys.executable, binary=str(real)))
        quiet.chmod(0o755)
    server = native.NativeStateServer(host="127.0.0.1", port=0)
    server.start()
    os.environ["TIK_STATE_PORT"] = str(server.port)
    return server, {k: s for k, (_, s) in built.items()}


def _advertised(dev_root: str, proc_root: str, expect_gpus, phase: str
                ) -> dict:
    """What a node agent of this host advertises: the port's detection,
    with a `dev_root` or `proc_root` other than the host's reaching the
    agent through TIK_NODE_RESOURCES, as the bootstrapped start commands
    carry it.  At least one card, and torch's count where given."""
    from cloudtik_tpu_torch.utils.resource_spec import detect_node_resources

    want = detect_node_resources(dev_root, None, proc_root)
    if (dev_root, proc_root) != ("/dev", "/proc"):
        os.environ["TIK_NODE_RESOURCES"] = subprocess.run(
            [sys.executable, "-m", "cloudtik_tpu_torch.utils.resource_spec",
             "--dev-root", dev_root, "--proc-root", proc_root],
            cwd=str(Path(__file__).resolve().parent), capture_output=True,
            text=True, check=True, timeout=60).stdout.strip()
    require(want.get("GPU", 0) >= 1 and (
        expect_gpus is None or want["GPU"] == expect_gpus),
        f"{phase}: the host advertises {want}, torch sees {expect_gpus} "
        "cards")
    return want


def _check_rank(r: dict, load: RuntimeLoad, on_card: bool, phase: str
                ) -> dict:
    """Holds a rank's result (`runtime_rank`'s JSON): nothing built from
    the warm cache, finite losses, nothing of JAX loaded, and the tpu_1b
    layers' launches of each of B1-B3 in every warm-up and measured step
    (none on the CPU).  Returns the launches a step."""
    require(r["built"] == [] and r["compile_s"] == 0,
            f"{phase}: the rank built {r['built']} (compile bucket "
            f"{r['compile_s']} s) from the warm cache")
    require(all(math.isfinite(x) for x in r["losses"]),
            f"{phase}: the rank's losses {r['losses']}")
    require(r["jax_modules"] == [],
            f"{phase}: the rank loaded {r['jax_modules']}")
    n = r["n_layers"] if on_card else 0
    per_step = {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    require(r["warmup_launches"] == {
        k: v * load.warmup for k, v in per_step.items()}
        and r["launches"] == {
            k: v * load.steps for k, v in per_step.items()},
        f"{phase}: the rank's launches {r['warmup_launches']} in "
        f"{load.warmup} warm-up and {r['launches']} in {load.steps} "
        f"measured steps, expected {per_step} a step")
    return per_step


def _gated_rank(load: RuntimeLoad, spec: Path, rank_out: Path,
                rank_log: Path, gate: Path, pidfile: Path) -> tuple:
    """(the AI runtime's command for `runtime_rank` at `load`, a start
    command that runs it): the rank starts once the phase has read the
    card with the node's agent alive (the file `gate`), in the background
    as a service starts, so the updater marks the node up to date; its
    launcher's pid goes to `pidfile`."""
    import shlex

    from cloudtik_tpu_torch.runtimes.ai.runtime import AIRuntime

    spec.write_text(json.dumps(dataclasses.asdict(load)))
    cmd = AIRuntime({"python": sys.executable}).get_runnable_command(
        str(Path(__file__).resolve().parent / "chip_smoke.py"),
        ["--nproc-per-node", "1", "--deadline-s", str(load.deadline_s)])
    cmd += ["--runtime-rank", str(spec), str(rank_out)]
    start = (f"until [ -e {shlex.quote(str(gate))} ]; do sleep 0.05; "
             f"done; nohup {shlex.join(cmd)} > "
             f"{shlex.quote(str(rank_log))} 2>&1 < /dev/null & "
             f"echo $! > {shlex.quote(str(pidfile))}")
    return cmd, start


def _h100_cluster(name: str, provider: dict, want: dict, load,
                  start_commands: list, **extra) -> dict:
    """A bootstrapped cluster config of a head that claims no host and one
    `h100` worker type advertising `want`, released for idle after
    `load.idle_timeout_s`, running the AI runtime; `extra` are more
    top-level keys."""
    from cloudtik_tpu_torch.control import cluster_operator

    return cluster_operator.bootstrap_config({
        "cluster_name": name, "workspace_name": "card",
        "provider": provider, "head_node_type": "head", "max_workers": 1,
        "idle_timeout_minutes": load.idle_timeout_s / 60.0,
        "available_node_types": {
            "head": {"node_config": {}, "min_workers": 0, "max_workers": 0,
                     "resources": {"CPU": want["CPU"]}},
            "h100": {"node_config": {}, "min_workers": 0, "max_workers": 1,
                     "resources": dict(want)}},
        "runtime": {"types": ["ai"]},
        "file_mounts": {}, "initialization_commands": [],
        "setup_commands": [], "worker_setup_commands": [],
        "worker_start_commands": list(start_commands), **extra})


def _scaler_decisions(journal: Path, node: str, t_job: float,
                      t_result: float, phase: str) -> list:
    """The scaler's decisions in the head's journal, held: one launch of
    one `h100` host for demand after the job came, and one termination of
    `node` for `idle_timeout` after the rank's result."""
    from cloudtik_tpu_torch.telemetry import events

    decisions = [e for e in events.read_events(str(journal))
                 if e.get("name") == "tik_scaler_decision"]
    launches = [e for e in decisions if e["action"] == "launch"]
    stops = [e for e in decisions if e["action"] == "terminate"]
    require([(e["reason"], e["node_type"], e["count"])
             for e in launches] == [("demand", "h100", 1)]
            and launches[0]["ts"] > t_job,
            f"{phase}: launch decisions {launches}")
    require([(e["reason"], e["node_id"]) for e in stops]
            == [("idle_timeout", node)] and stops[0]["ts"] > t_result,
            f"{phase}: terminate decisions {stops}, the rank's result at "
            f"{t_result}")
    return decisions


def phase_control(load: ControlLoad = CONTROL_LOAD, expect_gpus: int = None,
                  dev_root: str = "/dev", proc_root: str = "/proc",
                  free_bytes=None, nvidia_smi: str = None) -> dict:
    """The port's control plane launching a card host for a pending
    training job (module docstring).  The smoke process is the head: the
    native state server, built by g++, and the port's `ClusterController`
    over its `VirtualNodeProvider`, whose nodes are local processes running
    the port's node agent.  `expect_gpus` is torch's card count (None on
    the CPU), `free_bytes` reads the card's free memory (None on the CPU);
    a `dev_root` or `proc_root` other than the host's reaches the agent as
    the bootstrapped start commands carry it, through TIK_NODE_RESOURCES.
    The flash launch counts are the rank's own, zeroed at its start."""
    import shlex
    import shutil
    import tempfile

    from cloudtik_tpu_torch.control.controller import ClusterController
    from cloudtik_tpu_torch.control.state import (
        StateClient, TABLE_HEARTBEAT, TABLE_METRICS, TcpStateBackend)
    from cloudtik_tpu_torch.core.tags import (
        STATUS_UP_TO_DATE, TAG_NODE_STATUS, TAG_USER_NODE_TYPE)
    from cloudtik_tpu_torch.providers.factory import create_node_provider
    from cloudtik_tpu_torch.runtimes.ai.scaling import AISliceScalingPolicy
    from cloudtik_tpu_torch.telemetry import core as telemetry_core
    from cloudtik_tpu_torch.telemetry import events

    on_card = load.rank.device == "cuda"
    t_phase = time.perf_counter()
    out = {"nvidia_smi": nvidia_smi, "load": dataclasses.asdict(load)}
    tmp = Path(tempfile.mkdtemp(prefix="tik-control-"))
    site, home = tmp / "site", tmp / "home"
    processes = tmp / "processes.jsonl"
    gate, pidfile = tmp / "gate", tmp / "rank.pid"
    rank_out, rank_log = tmp / "rank.json", tmp / "rank.log"
    spec = tmp / "load.json"
    saved_env = dict(os.environ)
    was_enabled = telemetry_core.STATE.enabled
    server = controller = provider = None
    try:
        _head_env(site, home, processes, tmp, on_card)
        server, out["native_build_s"] = _native_head(home, on_card,
                                                     "control")

        # ---- what the agent will advertise, and the worker type that asks
        # for just that ----
        want = _advertised(dev_root, proc_root, expect_gpus, "control")
        cmd, start = _gated_rank(load.rank, spec, rank_out, rank_log, gate,
                                 pidfile)
        config = _h100_cluster(
            "smoke-control", {"type": "virtual",
                              "root_dir": str(tmp / "nodes"),
                              "spawn_agents": True},
            want, load, [start])
        provider = create_node_provider(config["provider"],
                                        config["cluster_name"])
        head = StateClient(TcpStateBackend("127.0.0.1", server.port))
        reader = StateClient(TcpStateBackend("127.0.0.1", server.port))
        policy = AISliceScalingPolicy(
            config, "127.0.0.1", {"slice_resources": {"GPU": 1}},
            state_client=head)
        journal = home / "logs" / "events-control.jsonl"
        telemetry_core.enable()
        events.install(str(journal))
        controller = ClusterController(
            config, provider, head, scaling_policies=[policy],
            update_interval_s=load.update_interval_s)
        free_before = free_bytes() if free_bytes else None
        t0 = time.time()
        controller.start()

        # ---- no job, no launch ----
        _wait(f"{CONTROL_QUIET_TICKS} controller ticks",
              lambda: controller.ticks >= CONTROL_QUIET_TICKS, CONTROL_WAIT_S)
        out["quiet"] = {"ticks": controller.ticks,
                        "seconds": time.time() - t0,
                        "nodes": provider.non_terminated_nodes({})}
        require(out["quiet"]["nodes"] == [],
                f"control: {out['quiet']['nodes']} launched before any job")

        # ---- one pending job: one h100 host ----
        t_job = time.time()
        reader.table_put("ai_jobs", "smoke-job", {
            "status": "pending", "time": t_job,
            "command": shlex.join(cmd)})
        node = _wait("launch", lambda: provider.non_terminated_nodes({}),
                     CONTROL_WAIT_S)[0]
        record = provider._load(node)
        t_launch = record["created_at"]
        agent_pid = record["pid"]
        require(t_launch > t_job and provider.node_tags(node).get(
            TAG_USER_NODE_TYPE) == "h100",
            f"control: launched {node} ({record}) at {t_launch}, the job "
            f"came at {t_job}")
        hb = _wait("heartbeat",
                   lambda: reader.table_get(TABLE_HEARTBEAT, node),
                   CONTROL_WAIT_S, poll_s=0.02)
        out["agent_device_mib"] = (
            (free_before - free_bytes()) / 2**20 if free_bytes else None)
        # NVML, which names the card where /proc hides it, maps libcuda but
        # holds no device memory (tools/probe_torch_cuda_context.py); torch
        # or the CUDA runtime in the agent would be a fault
        out["agent_maps"] = _maps_hold(agent_pid, (
            "libtorch", "libc10", "libcudart"))
        gate.touch()
        t_gate = time.time()
        require(out["agent_device_mib"] is None
                or out["agent_device_mib"] < CONTEXT_MIB,
                f"control: the card lost {out['agent_device_mib']} MiB "
                f"with the agent alive: a CUDA context ({CONTEXT_MIB} MiB "
                "allowed)")
        require(out["agent_maps"] == [],
                f"control: the agent maps {out['agent_maps']}")
        _wait("up-to-date", lambda: provider.node_tags(node).get(
            TAG_NODE_STATUS) == STATUS_UP_TO_DATE, CONTROL_WAIT_S)
        t_up = time.time()

        # ---- the rank: the agent's metrics while it runs ----
        samples = {}

        def rank_done():
            m = reader.table_get(TABLE_METRICS, node)
            if m:
                samples[m["time"]] = m
            try:
                return json.loads(rank_out.read_text())
            except (OSError, ValueError):
                return None

        r = _wait("rank result", rank_done,
                  load.rank.deadline_s + CONTROL_WAIT_S, poll_s=0.25)
        t_result = rank_out.stat().st_mtime
        reader.table_put("ai_jobs", "smoke-job", {
            "status": "done", "time": time.time(),
            "command": shlex.join(cmd)})
        t_done = time.time()
        want_launches = _check_rank(r, load.rank, on_card, "control")

        # ---- idle: terminated, after the rank, for idle_timeout ----
        def terminated():
            m = reader.table_get(TABLE_METRICS, node)
            if m:
                samples[m["time"]] = m
            return provider.is_terminated(node)

        _wait("termination", terminated, load.idle_timeout_s + CONTROL_WAIT_S)
        t_term = time.time()

        # ---- the heartbeat, the resources, the native sampler ----
        native_rows = [m for m in samples.values() if m.get("native")]
        require(native_rows, "control: no metrics from the native sampler "
                f"in {len(samples)} rows")
        total = native_rows[-1]["total_resources"]
        require(total == want,
                f"control: the agent advertises {total}, the host {want}")
        agent_log = (Path(record["dir"]) / "agent.log").read_text()
        require(_SAMPLER_WARNING not in agent_log,
                f"control: the agent fell back to psutil:\n{agent_log}")
        rank_cpu = [m["cpu_percent"] for t, m in sorted(samples.items())
                    if r["started_unix"] <= t <= t_result + 1.0]
        decisions = _scaler_decisions(journal, node, t_job, t_result,
                                      "control")
        _reap(agent_pid, CONTROL_WAIT_S)
        _wait("the agent's process group gone",
              lambda: not _group_alive(agent_pid), CONTROL_WAIT_S)
        require(provider.state.keys("virtual_nodes") == [node],
                f"control: nodes {provider.state.keys('virtual_nodes')}")

        # ---- no process of the phase loaded jax or cloudtik_tpu ----
        logged = [json.loads(line) for line in
                  processes.read_text().splitlines()]
        launcher_pid = int(pidfile.read_text())
        pids = {p["pid"] for p in logged}
        require({agent_pid, launcher_pid, r["pid"]} <= pids,
                f"control: the agent {agent_pid}, the launcher "
                f"{launcher_pid} or the rank {r['pid']} ran without the "
                f"guard (logged: {logged})")
        out.update({
            "node": node, "resources": total,
            "heartbeat": {k: hb[k] for k in ("node_ip", "time")},
            "native_rows": len(native_rows), "metrics_rows": len(samples),
            "rank_cpu_percent": rank_cpu, "processes": logged,
            "rank": {k: r[k] for k in (
                "model", "batch", "seq", "n_layers", "losses",
                "ms_per_step", "tokens_per_s", "launches",
                "warmup_launches", "launch_env", "peak_mem_gb")},
            "decisions": decisions,
            "timing": {
                "job_to_launch_s": t_launch - t_job,
                "launch_to_heartbeat_s": hb["time"] - t_launch,
                "heartbeat_to_up_to_date_s": t_up - hb["time"],
                "spawn_to_first_step_s": r["first_step_unix"] - t_gate,
                "step_ms": r["ms_per_step"],
                "heartbeat_to_result_s": t_result - hb["time"],
                "done_to_termination_s": t_term - t_done,
                "heartbeat_to_termination_s": t_term - hb["time"]},
            "launches": {k: r["warmup_launches"][k] + r["launches"][k]
                         for k in want_launches}})
    finally:
        gate.touch()
        if controller is not None:
            controller.stop()
            if controller._thread is not None:
                controller._thread.join(timeout=10)
        if provider is not None:
            for node_id in provider.non_terminated_nodes({}):
                provider.terminate_node(node_id)
        _stop_pidfile(pidfile)
        if server is not None:
            server.stop()
        events.uninstall()
        telemetry_core.STATE.enabled = was_enabled
        os.environ.clear()
        os.environ.update(saved_env)
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit("control", **out)
    return out


# --------------------------------------------------------- local_provider --

def phase_local_provider(load: ControlLoad = CONTROL_LOAD,
                         expect_gpus: int = None, dev_root: str = "/dev",
                         proc_root: str = "/proc", free_bytes=None,
                         nvidia_smi: str = None) -> dict:
    """The control phase's loop with the `local` provider in place of the
    virtual one (module docstring): the inventory is this machine, and
    `auth.executor: local` runs the worker's commands on it.  The smoke
    process is the head (the native state server and the port's
    `ClusterController`) and claims no host; the worker's start command
    boots the host's node services (`node start --daemonize`, the node id
    its address), which heartbeat, then runs the control phase's rank.
    The provider's release deletes the claim only, so the phase stops the
    node services itself, through the executor, as `teardown_cluster`
    stops a head's.  Arguments as `phase_control`'s."""
    import shlex
    import shutil
    import tempfile

    from cloudtik_tpu_torch.control.controller import ClusterController
    from cloudtik_tpu_torch.control.executor.factory import (
        make_command_executor)
    from cloudtik_tpu_torch.control.node_agent import _local_ip
    from cloudtik_tpu_torch.control.services import (
        node_services_pid_file, write_bootstrap_config)
    from cloudtik_tpu_torch.control.state import (
        StateClient, TABLE_HEARTBEAT, TABLE_METRICS, TcpStateBackend)
    from cloudtik_tpu_torch.core.tags import (
        NODE_KIND_WORKER, STATUS_UP_TO_DATE, TAG_NODE_KIND, TAG_NODE_STATUS,
        TAG_USER_NODE_TYPE)
    from cloudtik_tpu_torch.providers.factory import create_node_provider
    from cloudtik_tpu_torch.providers.local.node_provider import (
        _CLAIMS_NS, LocalNodeProvider)
    from cloudtik_tpu_torch.runtimes.ai.scaling import AISliceScalingPolicy
    from cloudtik_tpu_torch.telemetry import core as telemetry_core
    from cloudtik_tpu_torch.telemetry import events
    from cloudtik_tpu_torch.utils.call_context import CallContext
    from cloudtik_tpu_torch.utils.constants import (
        TIK_BOOTSTRAP_CONFIG_REMOTE)

    phase = "local_provider"
    # the inventory's one host: this machine, listed under the address its
    # node agent reports in each heartbeat, which is how the controller
    # matches a host to its agent; the address is its node id
    host = _local_ip()
    on_card = load.rank.device == "cuda"
    t_phase = time.perf_counter()
    out = {"nvidia_smi": nvidia_smi, "load": dataclasses.asdict(load)}
    tmp = Path(tempfile.mkdtemp(prefix="tik-local-"))
    site, home = tmp / "site", tmp / "home"
    tik_home, claims_root = home / ".tik", tmp / "claims"
    processes = tmp / "processes.jsonl"
    gate, pidfile = tmp / "gate", tmp / "rank.pid"
    rank_out, rank_log = tmp / "rank.json", tmp / "rank.log"
    spec, staged = tmp / "load.json", tmp / "bootstrap-config.yaml"
    saved_env = dict(os.environ)
    was_enabled = telemetry_core.STATE.enabled
    server = controller = provider = None
    services_pidfile = None

    def claims() -> dict:
        return {h: json.loads(provider.state.get(_CLAIMS_NS, h).decode())
                for h in provider.state.keys(_CLAIMS_NS)}

    try:
        # the worker's `~/.tik` (the bootstrap config's mount point) is
        # the phase's TIK_HOME
        _head_env(site, tik_home, processes, tmp, on_card)
        os.environ["HOME"] = str(home)
        # the node services' pidfile, as their process names it (this
        # process took its TIK_RUN_DIR at import)
        services_pidfile = tik_home / "run" / Path(
            node_services_pid_file("smoke-local")).name
        server, out["native_build_s"] = _native_head(tik_home, on_card,
                                                     phase)
        want = _advertised(dev_root, proc_root, expect_gpus, phase)
        cmd, rank_start = _gated_rank(load.rank, spec, rank_out, rank_log,
                                      gate, pidfile)
        node_start = [sys.executable, "-m", "cloudtik_tpu_torch.scripts.cli",
                      "node", "start", "--node-id", host,
                      "--head-ip", "127.0.0.1", "--daemonize"]
        config = _h100_cluster(
            "smoke-local", {"type": "local", "hosts": [host],
                            "state_root": str(claims_root)},
            want, load, [shlex.join(node_start), rank_start],
            auth={"executor": "local"}, state_port=server.port,
            telemetry_port=0)
        config["file_mounts"] = {TIK_BOOTSTRAP_CONFIG_REMOTE: str(staged)}
        write_bootstrap_config(config, str(staged))
        provider = create_node_provider(config["provider"],
                                        config["cluster_name"])
        require(type(provider) is LocalNodeProvider,
                f"{phase}: the factory gave {type(provider)}")
        head = StateClient(TcpStateBackend("127.0.0.1", server.port))
        reader = StateClient(TcpStateBackend("127.0.0.1", server.port))
        policy = AISliceScalingPolicy(
            config, "127.0.0.1", {"slice_resources": {"GPU": 1}},
            state_client=head)
        journal = tik_home / "logs" / "events-local.jsonl"
        telemetry_core.enable()
        events.install(str(journal))
        controller = ClusterController(
            config, provider, head, scaling_policies=[policy],
            update_interval_s=load.update_interval_s)
        free_before = free_bytes() if free_bytes else None
        t0 = time.time()
        controller.start()

        # ---- no job, no claim ----
        _wait(f"{CONTROL_QUIET_TICKS} controller ticks",
              lambda: controller.ticks >= CONTROL_QUIET_TICKS, CONTROL_WAIT_S,
              phase=phase)
        out["quiet"] = {"ticks": controller.ticks,
                        "seconds": time.time() - t0, "claims": claims()}
        require(out["quiet"]["claims"] == {},
                f"{phase}: {out['quiet']['claims']} claimed before any job")

        # ---- one pending job: the host claimed ----
        t_job = time.time()
        reader.table_put("ai_jobs", "smoke-job", {
            "status": "pending", "time": t_job,
            "command": shlex.join(cmd)})
        node = _wait("claim", lambda: provider.non_terminated_nodes({}),
                     CONTROL_WAIT_S, phase=phase)[0]
        claim = claims()
        require(node == host and list(claim) == [host]
                and claim[node]["cluster"] == "smoke-local"
                and claim[node]["time"] > t_job
                and claim[node]["tags"].get(TAG_USER_NODE_TYPE) == "h100",
                f"{phase}: claims {claim} for the job at {t_job}")
        t_claim = claim[node]["time"]
        hb = _wait("heartbeat",
                   lambda: reader.table_get(TABLE_HEARTBEAT, node),
                   CONTROL_WAIT_S, poll_s=0.02, phase=phase)
        daemon = int(_wait("the node-services pidfile",
                           lambda: services_pidfile.exists()
                           and services_pidfile.read_text().strip(),
                           CONTROL_WAIT_S, phase=phase))
        argv = Path(f"/proc/{daemon}/cmdline").read_bytes().split(b"\0")
        out["services_device_mib"] = (
            (free_before - free_bytes()) / 2**20 if free_bytes else None)
        gate.touch()
        t_gate = time.time()
        require(b"--node-id" in argv and argv[argv.index(b"--node-id") + 1]
                == host.encode(),
                f"{phase}: the node services run {argv}")
        require(out["services_device_mib"] is None
                or out["services_device_mib"] < CONTEXT_MIB,
                f"{phase}: the card lost {out['services_device_mib']} MiB "
                f"with the node services alive: a CUDA context "
                f"({CONTEXT_MIB} MiB allowed)")
        _wait("up-to-date", lambda: provider.node_tags(node).get(
            TAG_NODE_STATUS) == STATUS_UP_TO_DATE, CONTROL_WAIT_S,
            phase=phase)
        t_up = time.time()

        # ---- the rank: the agent's metrics while it runs ----
        samples = {}

        def sample():
            m = reader.table_get(TABLE_METRICS, node)
            if m:
                samples[m["time"]] = m

        def rank_done():
            sample()
            try:
                return json.loads(rank_out.read_text())
            except (OSError, ValueError):
                return None

        r = _wait("rank result", rank_done,
                  load.rank.deadline_s + CONTROL_WAIT_S, poll_s=0.25,
                  phase=phase)
        t_result = rank_out.stat().st_mtime
        reader.table_put("ai_jobs", "smoke-job", {
            "status": "done", "time": time.time(),
            "command": shlex.join(cmd)})
        t_done = time.time()
        per_step = _check_rank(r, load.rank, on_card, phase)

        # ---- idle: the claim released, after the rank, for idle_timeout ---
        def released():
            sample()
            return provider.is_terminated(node)

        _wait("release", released, load.idle_timeout_s + CONTROL_WAIT_S,
              phase=phase)
        t_release = time.time()
        require(claims() == {}, f"{phase}: claims {claims()} after release")
        decisions = _scaler_decisions(journal, node, t_job, t_result, phase)

        # ---- what the agent advertised: the card, through the native
        # sampler ----
        native_rows = [m for m in samples.values() if m.get("native")]
        require(native_rows, f"{phase}: no metrics from the native sampler "
                f"in {len(samples)} rows")
        total = native_rows[-1]["total_resources"]
        models = [k for k in total if k.startswith("accelerator_type:")]
        require(total == want and (expect_gpus is None
                                   or total["GPU"] == expect_gpus)
                and len(models) == 1 and "H100" in models[0],
                f"{phase}: the agent advertises {total}, the host {want}, "
                f"torch sees {expect_gpus} cards")
        services_log = (tik_home / "logs" / "node-services.log").read_text()
        require(_SAMPLER_WARNING not in services_log,
                f"{phase}: the agent fell back to psutil:\n{services_log}")

        # ---- the release leaves the host's node services running: stop
        # them through the executor, as a teardown stops a head's ----
        out["services_alive_after_release"] = _pid_alive(daemon)
        executor = make_command_executor(
            CallContext(), f"[{node}] ", node, provider, config["auth"],
            config["cluster_name"])
        t0 = time.perf_counter()
        executor.run(f"{shlex.quote(sys.executable)} -m "
                     "cloudtik_tpu_torch.scripts.cli node stop", timeout=60)
        _wait("the node services to exit", lambda: not _pid_alive(daemon),
              CONTROL_WAIT_S, phase=phase)
        t_services = time.perf_counter() - t0
        logged = [json.loads(line) for line in
                  processes.read_text().splitlines()]
        launcher_pid = int(pidfile.read_text())
        pids = {p["pid"] for p in logged}
        require({daemon, launcher_pid, r["pid"]} <= pids,
                f"{phase}: the node services {daemon}, the launcher "
                f"{launcher_pid} or the rank {r['pid']} ran without the "
                f"guard (logged: {logged})")
        _wait("every process of the phase to exit",
              lambda: not [p for p in pids if _pid_alive(p)], CONTROL_WAIT_S,
              phase=phase)
        if free_bytes:
            _wait("the card's memory back", lambda: free_bytes()
                  >= free_before - 2**30, CONTROL_WAIT_S, poll_s=0.25,
                  phase=phase)
            out["free_mib_lost"] = (free_before - free_bytes()) / 2**20

        # ---- the host free again: a second provider over the same claims
        # claims it and releases it ----
        again = LocalNodeProvider({"hosts": [host],
                                   "state_root": str(claims_root)},
                                  "smoke-local-again")
        got = again.create_node({}, {TAG_NODE_KIND: NODE_KIND_WORKER}, 1)
        require(list(got) == [host]
                and again.non_terminated_nodes({}) == [host],
                f"{phase}: a second provider claimed {got}")
        require(again.terminate_node(host) == {host: "released"}
                and again.state.keys(_CLAIMS_NS) == [],
                f"{phase}: the second claim stays "
                f"{again.state.keys(_CLAIMS_NS)}")
        out.update({
            "node": node, "resources": total, "native_rows": len(native_rows),
            "metrics_rows": len(samples),
            "heartbeat": {k: hb[k] for k in ("node_ip", "time")},
            "services_argv": [a.decode() for a in argv[1:]],
            "processes": logged, "decisions": decisions,
            "rank": {k: r[k] for k in (
                "model", "batch", "seq", "n_layers", "losses",
                "ms_per_step", "tokens_per_s", "launches",
                "warmup_launches", "peak_mem_gb")},
            "timing": {
                "job_to_claim_s": t_claim - t_job,
                "claim_to_heartbeat_s": hb["time"] - t_claim,
                "heartbeat_to_up_to_date_s": t_up - hb["time"],
                "spawn_to_first_step_s": r["first_step_unix"] - t_gate,
                "step_ms": r["ms_per_step"],
                "heartbeat_to_result_s": t_result - hb["time"],
                "done_to_release_s": t_release - t_done,
                "heartbeat_to_release_s": t_release - hb["time"],
                "node_stop_s": t_services},
            "launches": {k: r["warmup_launches"][k] + r["launches"][k]
                         for k in per_step}})
    finally:
        gate.touch()
        if controller is not None:
            controller.stop()
            if controller._thread is not None:
                controller._thread.join(timeout=10)
        if provider is not None:
            for node_id in provider.non_terminated_nodes({}):
                provider.terminate_node(node_id)
        for path in (services_pidfile, pidfile):
            _stop_pidfile(path)
        if server is not None:
            server.stop()
        events.uninstall()
        telemetry_core.STATE.enabled = was_enabled
        os.environ.clear()
        os.environ.update(saved_env)
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit(phase, **out)
    return out


# -------------------------------------------------------------- lifecycle --

@dataclasses.dataclass(frozen=True)
class LifecycleLoad:
    """The lifecycle phase (module docstring).  The head's `ServingRuntime`
    serves `serve_model` through the engine (`slots` lanes of `max_len`
    tokens) on `device`; each of `requests` is (name, concurrent HTTP
    requests, prompt tokens, new tokens); the submitted job is `rank`
    (the control phase's); `chaos passes` scaler passes `chaos_interval_s`
    apart a drill; `wait_s` bounds every wait of the phase."""
    device: str = "cuda"
    serve_model: str = "tpu_1b"
    slots: int = 2
    max_len: int = 512
    requests: tuple = (("greedy_b1", 1, 128, 32), ("greedy_b2", 2, 64, 16))
    rank: RuntimeLoad = CONTROL_LOAD.rank
    chaos_passes: int = 3
    chaos_interval_s: float = 1.0
    wait_s: float = 300.0


LIFECYCLE_LOAD = LifecycleLoad()
# the CPU rehearsal at `tiny`
LIFECYCLE_REHEARSAL = LifecycleLoad(
    device="cpu", serve_model="tiny", max_len=64,
    requests=(("greedy_b1", 1, 8, 4), ("greedy_b2", 2, 6, 4)),
    rank=CONTROL_REHEARSAL.rank, wait_s=120.0)
# the drill's plan: a launch that fails once, and the scaler's second node
# listing delayed (the drill's process runs no node agent, so a heartbeat
# seam cannot fire there)
LIFECYCLE_PLAN = """seed: 23
name: lifecycle-drill
faults:
  - seam: provider.create_node
    kind: raise
    times: 1
  - seam: provider.non_terminated_nodes
    kind: latency
    at_call: 2
    times: 1
    args: {seconds: 0.2}
"""


def _life_cli(env: dict, *args: str, timeout_s: float = 600.0) -> tuple:
    """(stdout, seconds) of `python -m cloudtik_tpu_torch.scripts.cli
    *args` (with `env`'s sitecustomize, `import jax` raises in it); fails
    the phase on an exit other than 0."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "cloudtik_tpu_torch.scripts.cli", *args],
        cwd=str(Path(__file__).resolve().parent), env=env,
        capture_output=True, text=True, timeout=timeout_s)
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"lifecycle: `tik {' '.join(args)}` exited {proc.returncode}: "
            f"{proc.stdout[-1500:]}\n{proc.stderr[-2500:]}")
    words = itertools.takewhile(lambda a: not a.startswith(("/", "-")),
                                args)
    emit("lifecycle_step", step=" ".join(words), seconds=seconds)
    return proc.stdout, seconds


def _pid_alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _traced_generate(url: str, prompt: list, new_tokens: int,
                     trace_id: str) -> dict:
    """One greedy request in trace `trace_id`: its tokens and headers."""
    req = urllib.request.Request(
        url, data=json.dumps({"tokens": [prompt],
                              "max_new_tokens": new_tokens}).encode(),
        headers={"Content-Type": "application/json",
                 "traceparent": f"00-{trace_id}-{'1' * 16}-01"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        body = json.loads(resp.read())
        got = {"status": resp.status, "tokens": body.get("tokens"),
               "traceparent": resp.headers.get("x-tik-traceparent"),
               "wall_s": time.perf_counter() - t0, "trace_id": trace_id}
    require(got["status"] == 200 and trace_id in str(got["traceparent"]),
            f"lifecycle: the request in {trace_id} gave {got}")
    return got


def _collector_count(port: int) -> float:
    """tik_serve_requests_total summed over the series the prometheus
    collector scraped from the cluster's targets (its instant query), its
    own endpoint left out: the collector re-exports what it scraped, so
    scraping itself nests every series once more each cycle."""
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/v1/query?query="
                "tik_serve_requests_total", timeout=30) as resp:
            rows = json.loads(resp.read())["data"]["result"]
    except OSError:
        return -1.0
    return sum(float(r["value"][1]) for r in rows
               if not r["metric"]["instance"].endswith(f":{port}"))


def _life_spans(env: dict, tmp: Path, traced: dict,
                telemetry_port: int) -> dict:
    """`cluster trace export --trace-id` of one request: its serve spans
    once each, in the head's `telemetry` lane."""
    trace_id = traced["trace_id"]
    path = tmp / f"trace-{trace_id}.json"
    _life_cli(env, "cluster", "trace", "export", "--trace-id", trace_id,
              "-o", str(path))
    trace = json.loads(path.read_text())
    lanes = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"]
             if e.get("ph") == "M"}
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    keys = [(e["name"], e["ts"], e["dur"], json.dumps(e.get("args"),
                                                      sort_keys=True))
            for e in spans]
    names = [e["name"] for e in spans]
    lane = f"telemetry (127.0.0.1:{telemetry_port})"
    require(len(keys) == len(set(keys))
            and {"serve.enqueue", "serve.prefill", "serve.decode"}
            <= set(names) and names.count("serve.enqueue") == 1
            and {lanes.get(e["pid"]) for e in spans} == {lane},
            f"lifecycle: the trace of {trace_id} holds "
            f"{[(lanes.get(e['pid']), e['name']) for e in spans][:24]}; "
            f"expected each serve span once, in the lane {lane}")
    return {"spans": len(spans), "names": sorted(set(names))}


def phase_lifecycle(load: LifecycleLoad = LIFECYCLE_LOAD, free_bytes=None,
                    nvidia_smi: str = None) -> dict:
    """The README's quickstart through the port's CLI (module docstring).
    `free_bytes` reads the card's free memory (None on the CPU).  The
    flash launch counts are the submitted rank's own, zeroed at its
    start; the smoke process's direct `generate` is the check's and not
    counted."""
    import shutil
    import socket
    import tarfile
    import tempfile
    import threading

    import numpy as np
    import torch
    import yaml

    from cloudtik_tpu_torch.control.state import StateClient, TcpStateBackend
    from cloudtik_tpu_torch.models import generate as G
    from cloudtik_tpu_torch.ops import _kernels
    from cloudtik_tpu_torch.providers.factory import create_node_provider
    from cloudtik_tpu_torch.runtimes.discovery.runtime import ServiceRegistry
    from cloudtik_tpu_torch.serve.server import transformer_backend

    def free_port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    on_card = load.device == "cuda"
    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    out = {"nvidia_smi": nvidia_smi, "load": dataclasses.asdict(load)}
    tmp = Path(tempfile.mkdtemp(prefix="tik-lifecycle-"))
    site, home = tmp / "site", tmp / "home"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_SITE_NO_JAX)
    processes = tmp / "processes.jsonl"
    env = {k: v for k, v in os.environ.items()
           if k not in ("TIK_NODE_RESOURCES", "TIK_EVENTS_PATH",
                        "TIK_STATE_PORT")}
    env.update({
        "PYTHONPATH": os.pathsep.join(
            [str(site), str(root)] + [p for p in os.environ.get(
                "PYTHONPATH", "").split(os.pathsep) if p]),
        "HOME": str(home), "TIK_HOME": str(home / ".tik"),
        "TMUX_TMPDIR": str(tmp), "TIK_SMOKE_PROCESS_LOG": str(processes)})
    if on_card:
        env["TIK_COMPILE_CACHE_DIR"] = str(_kernels.BUILD_DIR)
    else:
        cache = tmp / "cache"
        cache.mkdir()
        for name in _kernels._SIGNATURES:
            (cache / _kernels._target(name).name).touch()
        env["TIK_COMPILE_CACHE_DIR"] = str(cache)

    # ---- the answers: a direct `generate` on the seed-0 params the head's
    # engine makes, freed before the cluster starts ----
    rng = np.random.default_rng(0)
    backend = transformer_backend(load.serve_model, device=load.device)
    V = backend.cfg.vocab_size
    asks = []
    for name, batch, plen, new in load.requests:
        prompts = rng.integers(0, V, (batch, plen)).tolist()
        direct = G.generate(backend.params,
                            torch.tensor(prompts, device=load.device),
                            backend.cfg, max_new_tokens=new).cpu().tolist()
        asks.append((name, prompts, new, direct))
    del backend
    _collect(on_card)

    # ---- the cluster config: examples/serving-cluster.yaml on this
    # machine (haproxy needs its binary on the head, which may lack it) ----
    state_port, telemetry_port, prom_port, nodex_port = (
        free_port() for _ in range(4))
    config = yaml.safe_load((root / "examples" /
                             "serving-cluster.yaml").read_text())
    config.update({
        "cluster_name": "smoke-life", "state_port": state_port,
        "telemetry_port": telemetry_port,
        "provider": {"type": "virtual", "root_dir": str(tmp / "nodes")},
        "auth": {"executor": "local"},
        "runtime": {
            "types": ["nodex", "prometheus", "serving"],
            "nodex": {"port": nodex_port},
            "prometheus": {"port": prom_port, "scrape_interval_s": 1.0},
            "serving": {"model": load.serve_model, "device": load.device,
                        "engine": True, "slots": load.slots,
                        "max_len": load.max_len, "port": 0}}})
    cfg_file = tmp / "cluster.yaml"
    cfg_file.write_text(yaml.safe_dump(config))
    plan = tmp / "plan.yaml"
    plan.write_text(LIFECYCLE_PLAN)
    drills = []
    for i in (1, 2):
        drill = dict(config, cluster_name=f"smoke-life-drill{i}",
                     provider={"type": "virtual",
                               "root_dir": str(tmp / f"drill{i}")})
        drill["available_node_types"] = dict(config["available_node_types"])
        drill["available_node_types"]["worker"] = dict(
            config["available_node_types"]["worker"], min_workers=1)
        drills.append(tmp / f"drill{i}.yaml")
        drills[-1].write_text(yaml.safe_dump(drill))
    pid_file = home / ".tik" / "run" / "node-services-smoke-life.pid"
    steps = {}
    free_before = free_bytes() if free_bytes else None
    daemon = None
    try:
        text, steps["validate"] = _life_cli(env, "validate", str(cfg_file))
        require("valid" in text, f"lifecycle: `validate` printed {text!r}")
        _, steps["start"] = _life_cli(env, "start", str(cfg_file), "-y")
        t0 = time.perf_counter()
        daemon = int(_wait("the node-services pidfile",
                           lambda: pid_file.exists()
                           and pid_file.read_text().strip(), load.wait_s))
        state = StateClient(TcpStateBackend("127.0.0.1", state_port,
                                            timeout=5.0))
        registry = ServiceRegistry(state, "smoke-life", "default")

        def serving():
            try:
                listed = registry.query("serving")
            except Exception:
                return None
            return listed and listed[0]

        found = _wait("the serving service in discovery", serving,
                      load.wait_s, poll_s=0.25)
        steps["serving_up"] = time.perf_counter() - t0
        text, steps["status"] = _life_cli(env, "status", str(cfg_file))
        require("up-to-date" in text,
                f"lifecycle: `status` printed {text!r}")
        base = f"http://{found.get('ip') or '127.0.0.1'}:{found['port']}"

        # ---- the requests, each in its own trace ----
        served = {}
        n_request = 0
        for name, prompts, new, direct in asks:
            got = [None] * len(prompts)

            def ask(i, prompt):
                got[i] = _traced_generate(base + "/v1/generate", prompt,
                                          new, f"{n_request + i + 1:032x}")

            t0 = time.perf_counter()
            threads = [threading.Thread(target=ask, args=(i, p))
                       for i, p in enumerate(prompts)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            wall = time.perf_counter() - t0
            n_request += len(prompts)
            require(all(g is not None for g in got),
                    f"lifecycle: {name} went unanswered")
            tokens = [g["tokens"][0] for g in got]
            require([len(s) for s in tokens] == [new] * len(prompts),
                    f"lifecycle: {name} answered {tokens}")
            served[name] = {
                "requests": got, "prompts": prompts, "tokens": tokens,
                "wall_s": wall,
                "tokens_per_s": sum(map(len, tokens)) / wall,
                "equals_direct_generate": tokens == direct,
                "first_difference": [
                    next((j for j, (a, b) in enumerate(zip(s, d))
                          if a != b), None)
                    for s, d in zip(tokens, direct)]}
        steps["requests"] = sum(s["wall_s"] for s in served.values())
        traced = [g for s in served.values() for g in s["requests"]]

        # ---- the job: this script's rank, submitted ----
        spec, rank_out = tmp / "load.json", tmp / "rank.json"
        spec.write_text(json.dumps(dataclasses.asdict(load.rank)))
        tmux = shutil.which("tmux") is not None
        t_submit = time.time()
        _, steps["submit"] = _life_cli(
            env, "submit", *(["--tmux"] if tmux else []), str(cfg_file),
            str(root / "chip_smoke.py"), "--", "--runtime-rank", str(spec),
            str(rank_out))

        def rank_done():
            try:
                return json.loads(rank_out.read_text())
            except (OSError, ValueError):
                return None

        r = _wait("the submitted rank's result", rank_done,
                  load.rank.deadline_s + load.wait_s, poll_s=0.25)
        steps["job"] = time.time() - t_submit
        want_launches = _check_rank(r, load.rank, on_card, "lifecycle")
        if tmux:
            _wait("the job's tmux session to end", lambda: subprocess.run(
                ["tmux", "ls"], env=env, capture_output=True).returncode,
                load.wait_s, poll_s=0.25)

        # ---- one endpoint: each request's spans once, one count each ----
        targets = json.loads((home / ".tik" / "prometheus" /
                              "targets.json").read_text())
        jobs = sorted(g["labels"]["job"] for g in targets)
        require("telemetry" in jobs and "serving-telemetry" not in jobs,
                f"lifecycle: the scrape targets' jobs {jobs}")
        t0 = time.perf_counter()
        out["spans"] = [_life_spans(env, tmp, g, telemetry_port)
                        for g in traced]
        steps["trace_export"] = time.perf_counter() - t0
        _wait("the collector's count of the requests",
              lambda: _collector_count(prom_port) >= n_request, load.wait_s,
              poll_s=0.25)
        time.sleep(2 * 1.0)      # two more scrapes
        counted = _collector_count(prom_port)
        require(counted == n_request,
                f"lifecycle: the collector counts {counted} requests, "
                f"{n_request} were answered")

        # ---- the dump ----
        dump = tmp / "dump.tar.gz"
        _, steps["cluster_dump"] = _life_cli(
            env, "cluster-dump", str(cfg_file), "-o", str(dump))
        with tarfile.open(dump) as tar:
            members = {m.name: m for m in tar.getmembers() if m.isfile()}
            journals = [n for n in members if "/events/" in n]
            recorded = [json.loads(line) for n in journals for line in
                        tar.extractfile(members[n]).read().decode()
                        .splitlines()]
        names = [e.get("name") for e in recorded]
        admitted = {str(e.get("traceparent", "")).split("-")[1:2][0]
                    for e in recorded if e.get("name") ==
                    "tik_serve_admission" and e.get("traceparent")}
        require(any(n.endswith("/config/bootstrap-config.yaml")
                    for n in members)
                and any(n.endswith("/node-services.log") for n in members)
                and "tik_node_services_start" in names
                and {g["trace_id"] for g in traced} <= admitted,
                f"lifecycle: the dump holds {sorted(members)[:40]}, its "
                f"journals {journals} the events {sorted(set(names))} and "
                f"admissions under {sorted(admitted)}")
        out["dump"] = {"files": len(members), "journals": journals,
                       "events": len(recorded),
                       "admissions": names.count("tik_serve_admission")}

        # ---- the chaos drill, twice with one seed ----
        text, steps["chaos_validate"] = _life_cli(env, "chaos", "validate",
                                                  str(plan))
        require("Plan is valid (2 fault point(s))" in text,
                f"lifecycle: `chaos validate` printed {text!r}")
        runs = []
        for drill in drills:
            text, seconds = _life_cli(
                env, "chaos", "run", str(plan), "--config", str(drill),
                "--passes", str(load.chaos_passes), "--interval",
                str(load.chaos_interval_s), "--json")
            steps.setdefault("chaos_run", []).append(seconds)
            runs.append(json.loads(text[text.index("{"):]))
        fired = sorted((e["seam"], e["kind"]) for e in runs[0]["trace"])
        require(runs[0]["trace"] == runs[1]["trace"] and fired == [
            ("provider.create_node", "raise"),
            ("provider.non_terminated_nodes", "latency")],
            f"lifecycle: the drills' traces {runs[0]['trace']} and "
            f"{runs[1]['trace']}")
        out["chaos"] = {"trace": runs[0]["trace"],
                        "errors": runs[0]["errors"],
                        "summary": runs[0]["summary"]}
        for drill in drills:
            _life_cli(env, "stop", str(drill), "-y", "--hard")

        # ---- stop, then a hard teardown: nothing left ----
        _, steps["stop"] = _life_cli(env, "stop", str(cfg_file), "-y")
        t0 = time.perf_counter()
        _wait("the node services to exit",
              lambda: not _pid_alive(daemon), load.wait_s)
        steps["daemon_exit"] = time.perf_counter() - t0
        _, steps["hard_teardown"] = _life_cli(env, "stop", str(cfg_file),
                                              "-y", "--hard")
        logged = [json.loads(line) for line in
                  processes.read_text().splitlines()]
        pids = {p["pid"] for p in logged}
        require({daemon, r["pid"]} <= pids,
                f"lifecycle: the node services {daemon} or the job "
                f"{r['pid']} ran without the guard (logged: {logged})")
        _wait("every process of the phase to exit",
              lambda: not [p for p in pids if _pid_alive(p)], load.wait_s)
        left = []
        for path in [cfg_file] + drills:
            c = yaml.safe_load(path.read_text())
            left += create_node_provider(
                c["provider"], c["cluster_name"]).non_terminated_nodes({})
        require(left == [], f"lifecycle: nodes {left} left after stop")
        if free_bytes:
            _wait("the card's memory back", lambda: free_bytes()
                  >= free_before - 2**30, load.wait_s, poll_s=0.25)
            out["free_mib_lost"] = (free_before - free_bytes()) / 2**20
        daemon = None

        # ---- the answers, tie-aware (the engine's limit, as the engine
        # phase holds it): each served token's logit against the largest
        # at its position, teacher-forced on the same weights ----
        backend = transformer_backend(load.serve_model, device=load.device)
        for name, s in served.items():
            s["tie_gap"] = max(check_tie_aware(
                f"lifecycle: {name}", tie_gaps(
                    backend.params, backend.cfg, prompt, tokens,
                    load.device)) for prompt, tokens in zip(
                        s["prompts"], s["tokens"]))
        del backend
        _collect(on_card)
        out.update({
            "served": {k: {kk: vv for kk, vv in v.items()
                           if kk not in ("requests", "prompts")}
                       for k, v in served.items()},
            "traces": [g["trace_id"] for g in traced],
            "collector_count": counted, "jobs": jobs,
            "processes": len(logged), "steps": steps,
            "rank": {k: r[k] for k in (
                "model", "batch", "seq", "n_layers", "losses",
                "ms_per_step", "tokens_per_s", "launches",
                "warmup_launches", "peak_mem_gb")},
            "launches": {k: r["warmup_launches"][k] + r["launches"][k]
                         for k in want_launches}})
    finally:
        if daemon is not None and _pid_alive(daemon):
            with contextlib.suppress(ProcessLookupError):
                os.kill(daemon, 15)
        subprocess.run([sys.executable, "-m",
                        "cloudtik_tpu_torch.scripts.cli", "stop",
                        str(cfg_file), "-y", "--hard"], cwd=str(root),
                       env=env, capture_output=True, timeout=120)
        subprocess.run(["tmux", "kill-server"], env=env,
                       capture_output=True, timeout=60) \
            if shutil.which("tmux") else None
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit("lifecycle", **out)
    return out


def main() -> int:
    import torch

    t_script = time.perf_counter()
    if len(sys.argv) == 4 and sys.argv[1] == "--parallel-rank":
        load = ParallelLoad(**json.loads(Path(sys.argv[2]).read_text()))
        return parallel_rank(load, sys.argv[3])
    if len(sys.argv) == 4 and sys.argv[1] == "--elastic-rank":
        load = ElasticLoad(**json.loads(Path(sys.argv[2]).read_text()))
        return elastic_rank(load, sys.argv[3])
    if len(sys.argv) == 4 and sys.argv[1] == "--zoo-rank":
        load = ZooMeshLoad(**json.loads(Path(sys.argv[2]).read_text()))
        return zoo_rank(load, sys.argv[3])
    if len(sys.argv) == 4 and sys.argv[1] == "--runtime-rank":
        load = RuntimeLoad(**json.loads(Path(sys.argv[2]).read_text()))
        return runtime_rank(load, sys.argv[3])
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke runs on the "
              "card", file=sys.stderr)
        return 1
    from cloudtik_tpu_torch.ops import _kernels
    from cloudtik_tpu_torch.ops import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit("device", name=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # ---- the host as a cluster worker (no kernel: counts zeroed just
    # before, read just after) ----
    _zero_launch_counts()
    _zero_det_launch_counts()
    phase_hosts(torch.cuda.device_count(), kind,
                free_bytes=lambda: torch.cuda.mem_get_info(0)[0],
                nvidia_smi=smi)
    hosts_launches = {**_launch_counts(), **_det_launch_counts()}
    require(not any(hosts_launches.values()),
            f"the hosts phase launched {hosts_launches}, expected none")

    t0 = time.perf_counter()
    built = _kernels.build_all()
    ptxas = ptxas_report(_kernels.build_logs())
    emit("build", seconds=time.perf_counter() - t0, built=sorted(built),
         ptxas=ptxas)
    for name in NO_SPILL:
        row = next((r for r in ptxas if r["kernel"] == name), None)
        require(row is not None and row["spill_stores"] == 0,
                f"{name} spills or is missing from the build log: {row}")

    kernel = phase_kernel()
    kernel_bwd = phase_kernel_bwd()
    kernel_det = phase_kernel_det()
    kernel_paged = phase_kernel_paged()

    # ---- the inference path: counts zeroed just before, read just after --
    _zero_launch_counts()
    cfg, params, tokens, logits = forward_main()
    forward_launches = FA.LAUNCHES
    phase_serve()
    inference = _launch_counts()
    require(forward_launches == cfg.n_layers,
            f"forward launched the flash kernel {forward_launches} times, "
            f"expected {cfg.n_layers}")
    require(inference["flash_fwd"] >= 1,
            "the inference path never launched the flash kernel")

    phase_forward(cfg, params, tokens, logits, forward_launches)
    del params, logits
    torch.cuda.empty_cache()

    # ---- the engine path: counts zeroed just before, read just after ----
    # its decode attention is B6 (no Pallas kernel there: the reference's
    # einsums), its prefill chunks einsums as in the reference
    from cloudtik_tpu_torch.ops import paged_attention as PA

    _zero_launch_counts()
    _zero_det_launch_counts()
    PA.LAUNCHES = 0
    phase_engine(nvidia_smi=smi)
    engine_launches = {**_launch_counts(), **_det_launch_counts()}
    paged_launches = PA.LAUNCHES
    emit("engine_path", launches=engine_launches, paged_attn=paged_launches)
    require(not any(engine_launches.values()),
            f"the engine path launched {engine_launches}, expected none")
    require(paged_launches > 0,
            "the engine path never launched the paged attention kernel")

    # ---- the spec, lora, disagg and fabric paths, counts zeroed just
    # before each and read just after: the verify and the draft are
    # `forward_step`'s einsums, the LoRA delta is `gathered_delta`'s and
    # migration's gather and scatter are indexing, as in the reference;
    # their decode steps launch B6 ----
    for name, phase in (("spec", phase_spec), ("lora", phase_lora),
                        ("disagg", phase_disagg), ("fabric", phase_fabric)):
        _zero_launch_counts()
        _zero_det_launch_counts()
        PA.LAUNCHES = 0
        phase(nvidia_smi=smi)
        path_launches = {**_launch_counts(), **_det_launch_counts()}
        emit(f"{name}_path", launches=path_launches, paged_attn=PA.LAUNCHES)
        require(not any(path_launches.values()),
                f"the {name} path launched {path_launches}, expected none")
        require(PA.LAUNCHES > 0,
                f"the {name} path never launched the paged attention kernel")
        paged_launches += PA.LAUNCHES

    # ---- the training path (counts zeroed and read inside) ----
    train = phase_train()
    per_step = train["launches_per_step"]
    require(per_step == {"flash_fwd": cfg.n_layers,
                         "flash_bwd_dq": cfg.n_layers,
                         "flash_bwd_dkv": cfg.n_layers},
            f"train step launches {per_step}, expected {cfg.n_layers} of "
            "each kernel (save_attn must never re-run the forward)")
    torch.cuda.empty_cache()

    # ---- the checkpoint path (counts zeroed and read inside, around the
    # steps resumed past the torn checkpoint) ----
    checkpoint = phase_checkpoint()
    per_step = checkpoint["launches_per_step"]
    require(per_step == {"flash_fwd": cfg.n_layers,
                         "flash_bwd_dq": cfg.n_layers,
                         "flash_bwd_dkv": cfg.n_layers},
            f"resumed train step launches {per_step}, expected "
            f"{cfg.n_layers} of each kernel")
    torch.cuda.empty_cache()
    phase_train_grads()
    torch.cuda.empty_cache()

    # ---- LoRA training (counts zeroed and read inside, around the
    # measured steps), then the trained adapter served ----
    lora_train = phase_lora_train(nvidia_smi=smi)
    per_step = lora_train["launches_per_step"]
    n = lora_train["n_layers"]
    require(per_step == {"flash_fwd": n, "flash_bwd_dq": n,
                         "flash_bwd_dkv": n},
            f"lora_train step launches {per_step}, expected {n} of each "
            "kernel")

    # ---- BERT-Large pretraining (counts zeroed and read inside) ----
    bert = phase_bert(nvidia_smi=smi)
    per_step = bert["launches_per_step"]
    n = bert["n_layers"]
    require(per_step == {"flash_fwd": n, "flash_bwd_dq": n,
                         "flash_bwd_dkv": n},
            f"bert step launches {per_step}, expected {n} of each kernel")
    phase_bert_grads()
    torch.cuda.empty_cache()
    phase_optim(nvidia_smi=smi)
    torch.cuda.empty_cache()

    # ---- the detection path (counts zeroed and read inside) ----
    detect = {"maskrcnn": phase_detect("maskrcnn", "maskrcnn_resnet50"),
              "ssd": phase_detect("ssd", "ssd_resnet34"),
              "ssd1200": phase_detect("ssd", "ssd_resnet34",
                                      image_size=1200)}
    require(detect["ssd1200"]["nms_boxes_per_image"] == SSD1200_ANCHORS,
            f"ssd_resnet34 at 1200 gave NMS "
            f"{detect['ssd1200']['nms_boxes_per_image']} boxes an image")
    for model, per_call in (("maskrcnn", {"nms": 1, "roi_align": 2}),
                            ("ssd", {"nms": 1, "roi_align": 0}),
                            ("ssd1200", {"nms": 1, "roi_align": 0})):
        r = detect[model]
        want = {k: n * r["measured_calls"] for k, n in per_call.items()}
        require(r["launches"] == want,
                f"{r['model']} at {r['image_size']} detect launches "
                f"{r['launches']}, expected {want} ({per_call} per call)")
    det_launches = {k: sum(r["launches"][k] for r in detect.values())
                    for k in ("nms", "roi_align")}

    # ---- vision and detection training, then the loaders (counts zeroed
    # and read inside, around the measured steps and the streamed fit):
    # ResNet and SSD launch none of B1-B5, Mask R-CNN exactly its two
    # poolings a step ----
    phase_resnet_train(nvidia_smi=smi)
    phase_ssd_train(nvidia_smi=smi)
    maskrcnn_train = phase_maskrcnn_train(nvidia_smi=smi)
    det_launches["roi_align"] += maskrcnn_train["launches"]["roi_align"]
    loaders = phase_loaders(nvidia_smi=smi)

    # ---- the model zoo (counts zeroed and read inside, around the
    # measured steps, the cross-device checks and the GBDT fit, serve and
    # check): no B1-B5 launch on any of these paths ----
    t_zoo = time.perf_counter()
    phase_diffusion_train(nvidia_smi=smi)
    phase_diffusion_grads()
    phase_dlrm_train(nvidia_smi=smi)
    phase_rnnt_train(nvidia_smi=smi)
    phase_graphsage_train(nvidia_smi=smi)
    phase_gbdt(nvidia_smi=smi)
    emit("zoo", seconds=time.perf_counter() - t_zoo)

    # ---- mixture-of-experts (counts zeroed and read inside, around the
    # serving path and the measured train steps) ----
    t_moe = time.perf_counter()
    moe_train = phase_moe_train(nvidia_smi=smi)
    moe_serve = phase_moe_serve(nvidia_smi=smi)
    phase_moe_grads()
    emit("moe", seconds=time.perf_counter() - t_moe)

    # ---- the tensor and pipe axes: two ranks sharing the card over gloo
    # (counts zeroed and read inside each rank, around the measured
    # steps) ----
    t_par = time.perf_counter()
    parallel = phase_parallel_2rank(nvidia_smi=smi)
    emit("parallel", seconds=time.perf_counter() - t_par)

    # ---- elastic training: two processes sharing the card, one lost and
    # returned (counts zeroed and read inside each process, around its
    # fit_elastic) ----
    t_el = time.perf_counter()
    elastic = phase_elastic_2rank(nvidia_smi=smi,
                                  determinism=checkpoint.get("determinism"))
    emit("elastic", seconds=time.perf_counter() - t_el)

    # ---- the vision and zoo families on a mesh: two ranks sharing the
    # card over gloo (counts zeroed and read inside each rank, around the
    # measured Mask R-CNN and DLRM steps) ----
    t_zoo2 = time.perf_counter()
    zoo_mesh = phase_zoo_2rank(nvidia_smi=smi)
    det_launches["roi_align"] += zoo_mesh["launches"]["roi_align"]
    emit("zoo_mesh", seconds=time.perf_counter() - t_zoo2)

    # ---- the cluster runtimes: the serving runtime (counts zeroed and read
    # around its start, request and stop), then the AI runtime's launcher
    # starting one rank on a warm kernel cache (counts zeroed and read
    # inside the rank, around its measured steps) ----
    t_rt = time.perf_counter()
    runtime = phase_runtime(nvidia_smi=smi)
    emit("runtime_phase", seconds=time.perf_counter() - t_rt)

    # ---- the port's serving metrics on the cluster's scrape path (counts
    # zeroed and read around the serving parts, and around the captured
    # fit) ----
    t_obs = time.perf_counter()
    observe = phase_observe(nvidia_smi=smi)
    emit("observe_phase", seconds=time.perf_counter() - t_obs)

    # ---- the port's control plane launching a card host for a pending
    # training job, and scaling it down (counts zeroed and read inside the
    # launched rank, around its warm-up and its measured step) ----
    _collect(True)
    t_ctl = time.perf_counter()
    control = phase_control(
        expect_gpus=torch.cuda.device_count(),
        free_bytes=lambda: torch.cuda.mem_get_info(0)[0], nvidia_smi=smi)
    emit("control_phase", seconds=time.perf_counter() - t_ctl)

    # ---- the README's quickstart through the port's CLI: the head's
    # engine launches none of B1-B5, the submitted job its flash kernels
    # (counts zeroed and read inside the job, around its warm-up and its
    # measured step) ----
    _collect(True)
    t_life = time.perf_counter()
    lifecycle = phase_lifecycle(
        free_bytes=lambda: torch.cuda.mem_get_info(0)[0], nvidia_smi=smi)
    emit("lifecycle_phase", seconds=time.perf_counter() - t_life)

    # ---- the control loop over the `local` provider: this machine the
    # inventory's one host, whose node services the worker's start command
    # boots (counts zeroed and read inside the launched rank, around its
    # warm-up and its measured step) ----
    _collect(True)
    t_local = time.perf_counter()
    local = phase_local_provider(
        expect_gpus=torch.cuda.device_count(),
        free_bytes=lambda: torch.cuda.mem_get_info(0)[0], nvidia_smi=smi)
    emit("local_provider_phase", seconds=time.perf_counter() - t_local)

    main_case = kernel[ATTN_CASES[0].name]
    train_case = kernel_bwd[BWD_CASES[0].name]
    launches = {k: inference[k] + train["launches"][k]
                + checkpoint["launches"][k] + lora_train["launches"][k]
                + bert["launches"][k] + loaders["launches"][k]
                + moe_serve["launches"][k] + moe_train["launches"][k]
                + parallel["launches"][k] + elastic["launches"][k]
                + runtime["launches"][k] + observe["launches"][k]
                + control["launches"][k] + lifecycle["launches"][k]
                + local["launches"][k] for k in inference}

    def bwd_err(grads):
        return max(r["errors"][g]["max_abs"] for r in kernel_bwd.values()
                   for g in grads)

    summary = {"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "cloudtik_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "cloudtik_tpu/ops/flash_attention.py:54",
        "launches": launches["flash_fwd"],
        "max_abs_err": max(
            [r["o_max_abs_err"] for r in kernel.values()]
            + [r["fwd_errors"]["o_max_abs_err"]
               for r in kernel_bwd.values()]),
        "ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "cloudtik_tpu_torch/csrc/flash_bwd.cu",
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": bwd_err(grads),
        "ms": train_case[part]["kernel_ms"],
        "plain_ms": train_case["plain_ms"],
        "bound_ms": train_case[part]["bound_ms"],
        "bound_by": train_case[part]["bound_by"],
        "library_ms": train_case["library_ms"],
    } for name, part, grads, replaces in (
        ("flash_bwd_dq", "dq", ("dq",),
         "cloudtik_tpu/ops/flash_attention.py:150"),
        ("flash_bwd_dkv", "dkv", ("dk", "dv"),
         "cloudtik_tpu/ops/flash_attention.py:191"))]}
    # B4 at SSD's shape (the larger of the two detect shapes at the preset
    # sizes), with every detect shape beside it; B5 as one Mask R-CNN call
    # runs it, the 7x7 and the 14x14 launch together
    nms_main = kernel_det["nms"][NMS_CASES[1].name]
    roi_main = [kernel_det["roi_align"][c.name] for c in ROI_CASES[:2]]
    summary["kernels"] += [{
        "name": "nms",
        "route": "cuda",
        "source": "cloudtik_tpu_torch/csrc/nms.cu",
        "replaces": "cloudtik_tpu/ops/detection.py:100",
        "launches": det_launches["nms"],
        "max_abs_err": max(r["max_abs_err"]
                           for r in kernel_det["nms"].values()),
        "ms": nms_main["kernel_ms"],
        "plain_ms": nms_main["plain_ms"],
        "bound_ms": nms_main["bound_ms"],
        "bound_by": nms_main["bound_by"],
        "library_ms": None,
        "at": {n: {k: kernel_det["nms"][n][k] for k in (
            "kernel_ms", "plain_ms", "bound_ms", "bound_by", "kept",
            "reached", "reference_steps_bound_ms")}
            for n in NMS_DETECT_SHAPES},
    }, {
        "name": "roi_align",
        "route": "cuda",
        "source": "cloudtik_tpu_torch/csrc/roi_align.cu",
        "replaces": "cloudtik_tpu/ops/detection.py:203",
        "launches": det_launches["roi_align"],
        "max_abs_err": max(
            [r["max_abs_err"] for r in kernel_det["roi_align"].values()]
            + [r["forward_max_abs_err"]
               for r in kernel_det["roi_align_grad"].values()]
            + list(detect["maskrcnn"]["roi_align_max_abs_err"].values())),
        "ms": sum(r["kernel_ms"] for r in roi_main),
        "plain_ms": sum(r["plain_ms"] for r in roi_main),
        "bound_ms": sum(r["bound_ms"] for r in roi_main),
        "bound_by": "bytes",
        "library_ms": None,
    }]
    require(all(r["bound_by"] == "bytes" for r in roi_main),
            "roi_align's main shapes are not bound by bytes")
    # B6 at the chat cell's shape and length mix, launched by the engine,
    # spec, lora, disagg and fabric paths
    paged_main = kernel_paged[PAGED_CASES[0].name]
    summary["kernels"].append({
        "name": "paged_attn",
        "route": "cuda",
        "source": "cloudtik_tpu_torch/csrc/paged_attn.cu",
        "replaces": "none: the reference's decode attention is XLA einsums "
                    "(cloudtik_tpu/serve/engine.py _decode_layer)",
        "launches": paged_launches,
        "max_abs_err": max(r["max_abs_err"] for r in kernel_paged.values()),
        "ms": paged_main["kernel_ms"],
        "plain_ms": paged_main["plain_ms"],
        "bound_ms": paged_main["bound_ms"],
        "bound_by": paged_main["bound_by"],
        "library_ms": None,
    })
    emit("total", seconds=time.perf_counter() - t_script)
    print(smi, flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
