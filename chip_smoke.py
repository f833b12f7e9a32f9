#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA GPU).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``attention_lvcsr_torch/csrc`` and
drives the flagship decode (the ``__graft_entry__.FLAGSHIP_NET`` shape:
4x250 BiGRU encoder, conv-attention GRU decoder, beam 10) with random
weights made from a seed, without an LM, with the LM and under a
dictionary constraint; trains it; serves it waveforms; decodes and
trains it with a 4x250 BiLSTM encoder; decodes, scores and samples it
through the search driver; trains the paper's WSJ stages; and trains,
decodes and scores the TIMIT recipe's content-attention model with
adaptive weight noise; and trains the task-loss recipe with greedy
exploration, its kernel branches held to their plain versions; and
trains and decodes the WSJ recipes' readout and attention variants (ten
filters, maxout, the mean window, rectifier and no post-merge layer);
and trains and decodes the stacked decoders of the wsj_jan_* recipes;
and trains and serves wsj_pyramide.yaml's 250, 500 and 1000-unit encoder
through the GRU kernels' wide instances; and decodes beams 18-512 and
the long and D-wide decodes through the loop kernel's workspace
instances; and builds a word trigram's decoding graph with the port's
LM-graph command line, decodes with it fused in through the search
driver and scores the decodes with the port's scorer; and trains the
flagship network with dropout and weight noise through the training
services (plots, their server, the profiler, a data worker, the NaN
guard) and the native host DP; and decodes and trains the model
variants no recipe uses (the top MLP with one-hot feedback, the LSTM
and simple-RNN decoders, the simple-RNN encoder) and the autoencoder
prototype's lookup-bottom model; and trains the quality proxy's model on
its synthetic language and decodes it with and without that language's
LM.  Phases, each fatal on failure:

1. build the kernels (one nvcc per source, sm_90a) and print the time;
2. ``gru_scan`` kernel vs its plain PyTorch version at the encoder's
   first layer, T=800, B=64, D=250, both directions in one launch and one
   direction alone, masked with ragged lengths (max abs error <= 1e-4), a
   second call bit for bit; the C layout against its Python mirror, the
   clusters of 16 and of 8 blocks the card holds at once
   (``cudaOccupancyMaxActiveClusters``), the cluster size the launcher
   takes at B=32, 64, 128 and 256, and the kernel's time at B=128 and 256;
3. ``beam_search_loop`` kernel vs its plain version on flagship tables:
   U=8 at 400 frames, then the main path's U=64 at 800 frames, and U=64
   again with the EOS logit raised by 1.5 so that most utterances finish
   (at least 3/4 must).  Finished sets, lengths and step counts identical,
   costs within 1e-4 + 1e-5 relative; at most one utterance may differ, as
   a near tie (best costs within 1e-3 relative);
4. the full decode through ``SpeechRecognizer.beam_search`` at B=64, 800
   frames, beam 10: both kernels must launch; utt/s of the kernel path
   and of the plain path on the same card, whose outputs must agree as
   in phase 3;
5. serving: 8 concurrent ``/decode`` requests against the port's
   ``make_server`` and ``Transcriber`` equal the direct results;
6. ``beam_attention_energies`` kernel vs plain at U=64 (the LM decode's
   shape), 128 and 256, K=10, L=200, M=250 (max abs error <= 1e-4), a
   second call bit for bit; the launch plan and the kernel's time at each U
   (phases 6 and 7 time their kernels as CUDA graphs of 50 launches);
7. ``fused_decode_score`` kernel vs plain on the flagship tables and
   encoder outputs, U=64, for both priors, from the initial glimpses and
   from a later step with softmax-normalised random weights: costs,
   weights, energies and weighted averages within 1e-4, a second call bit
   for bit; the C layout against its Python mirror, the clusters of each
   size the card holds at once (``cudaOccupancyMaxActiveClusters``) and
   the size the launcher takes at U=1-256; at U=1, 16, 64, 128 and 256
   the same checks from a later step under both priors, the launch plan
   and the kernel's time;
8. LM-fused decode: the character trigram of ``bench.py`` (seed 11, 32
   symbols, no_transition_cost 20) built with the port's ``ops/fst.py``,
   weight 0.5, B=64, 800 frames, beam 10, char_discount 1.0, 100-step
   cap: ``gru_scan`` and ``beam_attention_energies`` launch,
   ``beam_search_loop`` does not; utt/s of both paths, outputs agree as in
   phase 3, then again with the EOS logit raised by 1.5;
9. constrained decode: ``use_pallas: fused`` under
   ``DecodeConstraint.from_words`` over a seeded lexicon, same shape, EOS
   logit raised by 1.5: ``fused_decode_score`` launches, every finished
   hypothesis is accepted by the constraint (host walk), outputs agree
   with the plain path;
10. serving with the LM: as phase 5, through the LM recognizer, one
    request per batch (the LM path's attention window spans its batch);
11. ``gru_scan_train`` forward and backward kernels vs the plain version
    (autograd through the plain scan): T=800, B=32, D=250, one direction
    and both, ragged mask, random cotangent; states within 1e-5, every
    gradient (dx_in, dx_gate, dh0, dW_ss, dW_sg) within 1e-4 of its
    largest value; times of the forward, of the autograd backward and of
    ``gru_train.cu``'s backward kernel alone (and per step); then
    ``outer_sum`` (the weight-gradient reduction of
    every training backward) vs its plain version on the four jobs of the
    bidirectional layer's backward, within 1e-5 of the largest value;
12. ``decoder_scan_train`` forward and backward kernels vs plain at the
    flagship decoder's shapes (T=100, B=32, L=200, M=250, D=500, S=250,
    201 taps), both priors, ragged label and frame masks: outputs and
    every gradient within 1e-4 of their largest value;
    in both phases a second call's gradients equal the first's bit for bit;
    the kernels' C shared-memory layout against its Python mirror, their
    launch plans at B=32 and 64 (clusters, blocks, rows a cluster, rows
    with resident tiles), and each kernel's time alone beside the forward
    and the autograd backward, at B=32 and B=64;
13. the flagship training step: five steps of ``make_train_step`` through
    ``run_training`` (B=32, 800 frames, 100 labels, wsj_paper.yaml's clip
    100, adadelta 0.95/1e-8, max_norm 1.0) on the kernel route and on the
    plain route from the same parameters and batches: per-step train_cost
    and total_gradient_norm within 1e-4 relative, the training kernels
    launch, utt/s of both routes, the checkpoint reads back identical, a
    second run of the kernel route repeats its monitors exactly; both
    routes also validate on two more batches, before the first step and
    after the fifth (``run_training``'s validation, ``net.cost`` under
    ``torch.no_grad()``): ``valid_sequence_total_cost`` within 1e-4
    relative; then two steps with a one-directional encoder (the path of
    the one-direction kernel), compared the same way;
14. ``fbank_deltas`` kernel vs its plain version: B=64, 8 s of 16 kHz
    speech-like audio (harmonic tones, envelope and noise from a numpy
    seed) with ragged true frame counts, then B=1 (one serving request)
    with 8 s at 16, 8, 22.05, 44.1 and 48 kHz; max abs error over the
    valid rows <= 1e-3 (log domain); the launch plan (a single request
    gets a block per SM) and the C layout against its mirror; times at
    B=1 and B=64, 16 kHz, as CUDA graphs of launches, the bound from the
    FFT route's operations, torch.fft.rfft of the same frames logged;
15. waveform serving: the flagship model behind ``make_server`` at
    ``max_batch`` 1 (an answer cannot depend on its batch companions), 8
    concurrent ``{"waveform": ...}`` requests of 2-8 s, one at 8 kHz: each
    answer equals the answer to a ``features`` request carrying the
    frontend kernel's own output for the same waveform, the frontend
    launches once a request, and a too-short waveform gets 400;
16. ``lstm_scan`` kernel vs plain at T=800, B=64, D=250, both directions
    and one alone, a second call bit for bit; ``lstm_scan_train`` forward
    and backward kernels vs plain (autograd through the plain scan) at
    T=800, B=32, both directions and one alone, ragged mask, random
    cotangent: states and cells within 1e-5, every gradient within 1e-4 of
    its largest value, a second call's gradients bit for bit; the C
    layouts of both kernels against their Python mirrors, the forward's
    cluster plan at B=32 and 64, and the times of the forward, of the
    autograd backward and of ``lstm_train.cu``'s backward kernel alone;
17. the flagship network with ``enc_transition: LSTM`` (4x250 BiLSTM,
    random weights from seed 1234): beam-10 decode at B=64, 800 frames,
    100-step cap through ``lstm_scan`` + ``beam_search_loop`` vs the plain
    route (outputs compared as in phase 3), utt/s of both; five training
    steps at B=32, 800 frames, 100 labels through ``lstm_scan_train`` +
    ``decoder_scan_train``, two on the plain route compared step by step
    (train_cost and total_gradient_norm within 1e-4 relative), a second
    kernel run repeating its monitors bit for bit, utt/s;
18. the search driver on the flagship network (random weights from seed
    1234, the EOS logit raised by 1.5, saved with ``save_checkpoint`` and
    loaded through ``create_model``) over 16 in-memory utterances (numpy
    seed 18, 300-800 frames, 20-80 labels, the flagship's character map):
    ``run_search`` (a) one utterance at a time over 4 of them
    (char_discount 3.0: below it the random model's best hypothesis is
    empty; ``beam_search_loop`` at U=1, ``analyze`` at B=1 through
    ``gru_scan_train_bidir`` and ``decoder_scan_train`` forward, twice an
    utterance), (b) in one chunk of 16 (the loop kernel at U=16), (c)
    with phase 8's trigram fused in, weight 0.5, char_discount 1.0, in
    one chunk of 16 (``beam_attention_energies``, the LM's teacher-forced
    pass in ``analyze``); (d) ``sample`` of 4 utterances
    (``beam_attention_energies`` at U=1).  Each runs again on the plain
    route (b's on 8 of the 16, the longest among them, as one chunk):
    the same hypotheses (at most one near tie), groundtruth and
    recognized costs within 1e-4 relative, the same CER and totals where
    the hypotheses agree, the same draws, and each sample's per-step costs
    within 1e-4 relative of its own teacher-forced ``analyze``; the kernels
    of each path launch and no other; utt/s of both routes and the
    shares of (a)'s wall time in ``analyze`` and in the beam search.  Then
    ``run_training``, 2 steps (adadelta epsilon 1e-10, no max-norm) with
    ``monitoring.search`` (beam 10, every batch) on 2 validation batches
    of 4 (300-400 frames) labelled with the loaded model's own
    hypotheses: in each of the 8 searches the same hypotheses on both
    routes and beam costs within 1e-5 relative, costs moved by more than
    1e-3 relative after a step, and the same ``valid_per`` records, 0
    before the steps and below 1 after them; the phase's seconds;
19. multistage training of the paper's recipe: the stages of
    ``exp/wsj/configs/wsj_paper.yaml`` written out as dicts (no YAML),
    ``pretraining`` (expanding prior, 1 epoch) -> ``main`` (restarted
    from ``pretraining_best_ll.zip``, 2 epochs of its 10) ->
    ``annealing`` (epsilon 1e-10, from ``main_best_ll.zip``, 1 epoch of
    its 3), through ``run_multistage`` at the flagship's widths from
    phase 18's start (seed 1234, EOS logit +1.5, char_discount 3.0 in
    place of the recipe's 0.1, below which the random model's best
    hypothesis is empty): 2 in-memory training batches of 16 (300-500
    frames, 30-60 labels) an epoch, validation and search (beam 10) on 4
    of their utterances before each stage and after each epoch; on the
    kernels, and each stage's start and first step on the plain route
    from the checkpoint the kernel route's stage loaded: every stage's
    files, the first step's train_cost and total_gradient_norm and the
    validation costs before it within 1e-4 relative, the same hypotheses
    in the start's search (beam costs within 1e-4 relative) and the same
    ``valid_per``; every kernel of the path launches; each stage's wall
    time and utt/s; then ``main`` on the
    kernels stopped after its first epoch and resumed from its
    checkpoint (``use_load_ext``) writes the bits of the straight run;
20. the TIMIT recipe, ``exp/timit/configs/nips_baseline.yaml`` at its
    widths (123 features, SpeechBottom [100] relu, 3x250 BiGRU
    subsampled 1, 2, 2, content attention, 250-unit decoder, one
    post-merge layer of 250, 63 phones), random weights from seed 1234:
    (a) ``decoder_scan_train``'s content branch (``n_filters=0``, the
    full-window prior) forward and backward vs plain at B=16, T=75 labels,
    L=175 frames, M=250, D=500, S=250, phase 12's tolerance, a second
    call's gradients bit for bit, the C layouts of both branches against
    the mirror (phase 12's check), the kernels' times alone and through
    autograd; (b) ``beam_search_loop``'s content branch vs plain at U=16
    and 64, beam 10, L=175, the recipe's optimistic stop and 3.0-fold
    cap, char_discount 1.0 (at 3.0 the random model's hypotheses repeat
    one symbol to the cap and its done sets hold cost ties within float32
    rounding), EOS logit +1.5 (3/4 of the utterances must finish),
    compared as in phase 3, its C layout against the mirror, both timed;
    (c) the three stages (``pretraining`` B=8 with max-norm, ``main`` and
    ``annealing`` with adaptive noise from the stage before's
    ``_best_ll``) through ``run_multistage``, 2 in-memory batches of
    300-700 frames and 20-75 labels an epoch, 1 epoch a stage,
    validation and search (beam 10 at U=4) before each stage and after
    each epoch, on the kernels, and each stage's start and first step on
    the plain route from the checkpoint the kernel route's stage loaded:
    the same parameter names (the log-variances in the noisy stages'),
    the first step's train_cost, total_gradient_norm and model_cost and
    the validation costs before it within 1e-4 relative, the same
    hypotheses and ``valid_per`` in the start's search, at least half the
    hypotheses non-empty and one ``valid_per`` below 1; then ``main`` for
    two epochs straight and stopped after one and resumed (no
    validation), bit for bit; (d) ``run_search`` at decode_batch 4 over 8
    utterances on ``annealing``'s model, kernels vs plain as phase 18
    compares them, at least 6 hypotheses non-empty; the seconds of a-b, c
    and d;
21. the task loss (``exp/timit/configs/iclr_reward.yaml``: nips_smooth's
    conv attention with the logistic normalizer, ``mse_gain``, greedy
    exploration): (a) the flagship at beam 20, U=16, 800 frames, whose
    loop state does not fit a block: ``search`` takes the loop kernel's
    workspace instance (phase 25) and finds the plain loop's best
    hypotheses; (b) ``beam_search_loop``'s ``mse_cost`` + logistic branch
    (the recipe's initialization) and its relu branch against their plain
    versions at U=64, L=175, beam 10, compared as in phase 3, with their
    C layouts and times; (c) ``decoder_scan_train``'s logistic and relu
    branches, forward and backward with the energy bias, against the
    plain version at B=16, T=75, L=175, 201 taps: states within 1e-5 and
    every gradient within 1e-4 of its largest value, a second call bit
    for bit, times; (d) the device reward/gain DP against the host numpy
    DP on a B=16 batch (equal integers), its time and device launches;
    (e) the recipe's ``pretraining`` (max-norm, ``min_reward`` -1) and
    ``pretraining2`` (from ``pretraining_best_ll.zip``) stages, one epoch
    of 2 batches of 8 each with validation and search (beam 10, U=4), on
    the kernels, and each stage's start and first step on the plain route
    from the checkpoint the kernel route's stage loaded: the first step's
    train_cost and total_gradient_norm and the validation costs before it
    within 1e-4 relative, the same hypotheses in the start's search (more
    than half of all non-empty), utt/s of the steps and the stages; then
    ``pretraining2`` stopped after an epoch and resumed, bit for bit;
    (f) one ``wsj_reward3.yaml`` (greedy) and one
    ``wsj_reward_mixed.yaml`` step at the flagship widths (B=32, 800
    frames, 100 labels) on both routes, within 1e-4 relative;
22. the readout and attention variants of the WSJ recipes: (a)
    ``beam_search_loop``'s ten filters + maxout:2 + states readout at
    ``wsj_mean_maxout.yaml``'s widths under the mean and the expanding
    prior, and its rectifier, sigmoid and identity post-merge activations
    at ``wsj_bhd4.yaml``'s, against the plain loop at U=64, 800 frames,
    beam 10, 100 steps, EOS logit +1.5, compared as in phase 3 (3/4 of the
    utterances must finish), a second launch bit for bit, the C layouts,
    the times; (b) ``decoder_scan_train``'s ten filters under the mean
    prior, forward and backward, against the plain scan at T=100, L=200,
    M=512, D=512, S=256, 201 taps, B=10 and 32: states within 1e-5 and
    every gradient (the taps' and the handler's included) within 1e-4 of
    its largest value, a second call bit for bit, the launch plans and C
    layouts, the times; (c) ``fused_decode_score``'s mean prior against
    its plain version at U=64, K=10, L=200 within 1e-4, the time; (d)
    ``wsj_mean_maxout.yaml``'s ``pretraining`` (expanding) and ``main``
    (mean, from ``pretraining_best_ll.zip``) stages and one stage each of
    ``wsj_bhd4.yaml`` and ``wsj_good.yaml`` (no subsampling, no post-merge
    layer: the module route), 2 batches of 10 an epoch with validation and
    search (beam 10, U=4), on the kernels and on the plain route (each
    stage's start and first step, from the checkpoint the kernel route's
    stage loaded): train_cost,
    total_gradient_norm and validation costs within 1e-4 relative, the
    same hypotheses (more than half of the compared ones non-empty),
    each recipe's decode route and launches, utt/s;
23. stacked GRU decoders (``dec_stack`` 2-4, the wsj_jan_* recipes): (a)
    ``beam_search_loop``'s stacked instance against the plain loop at
    wsj_jan_wsj13v2.yaml's widths (two 256-unit layers over a 3x256
    encoder, ten filters, maxout:2 with the states, M=512) at U=64, 400
    frames (L=200), beam 10, 100 steps, under the mean and the expanding
    prior, and at U=32 with wsj_jan_wsj15v2.yaml's two 512-unit layers
    (800 frames, L=200), three and four 64-unit layers, and
    wsj_jan_debug.yaml's 19-unit layers, compared as in phase 3, a second
    launch bit for bit, the C layouts, the times and bounds; (b)
    ``decoder_scan_train``'s stacked forward and backward against the
    plain scan (T=100, ten filters, the mean prior) at wsj13v2's decoder
    with L=400, B=10 and 32, at wsj15v2's with L=200, and with three and
    four 64-unit layers: states within 1e-5, every gradient (the
    interlayer tables' included) within 1e-4 of its largest value, a
    second call bit for bit, plans, C layouts, times; (c)
    wsj_jan_wsj13v2.yaml's ``pretraining`` and ``main`` (from
    ``pretraining_best_ll.zip``) on the kernels and on the plain route,
    2 batches of 10 utterances of 600-800 frames an epoch, validation and
    search (beam 10) on 4 of them cut to 400 frames, where the loop
    kernel holds the decode, compared as phase 22d compares; (d) two
    training steps of wsj_jan_wsj15v2.yaml and of wsj_jan_debug.yaml on
    the kernels, B=10, 800 frames, their launches;
24. the GRU kernels' wide instances (D above 448 forward, 384 backward,
    weights streamed from L2) and wsj_pyramide.yaml: (a) ``gru_scan``'s
    wide instance against the plain scan at U=64, both directions, a
    ragged mask, the recipe's layers D=500 over 800 frames and D=1000
    over 400 (states within 1e-5, a second call bit for bit, the C
    layouts against the mirror, the cluster chosen, times and bounds);
    (b) ``gru_scan_train_bidir`` through the wide instances against
    autograd through the plain scan at B=32 and the same widths, phase
    11's tolerances and times, and ``decoder_scan_train`` at the
    recipe's attention (D=2000, L=200) at B=10 and 32 against the plain
    scan; (c) the recipe's ``pretraining`` and
    ``main`` at its widths on the kernels and on the plain route, 2
    batches of 10 utterances of 600-800 frames an epoch, validation and
    search (the loop kernel's workspace instance) of 4 of them, compared
    as phase 22d compares; (d) the recipe's decode through
    ``Transcriber.transcribe_batch`` of 16 utterances of 600-800 frames
    at once, beam 10, char_discount 3.0 (the workspace instance): the
    plain route's hypotheses, most of them non-empty; (e) the resident
    routes at D=250 hash to the bits of the tree before the wide
    instances (``RESIDENT_BITS``), their times;
25. the loop kernel's workspace instances (``csrc/beam_loop_ws.cu``: the
    K-row buffers in a global workspace, for decodes whose resident
    layout passes a block): (a) against the plain loop on the flagship's
    tables, 800 frames, a 100-step cap, EOS logit +1.5, compared as in
    phase 3 (3/4 of the utterances must finish): U=64 at beam 18, 64 and
    200, U=8 at beam 512, odd widths (S=251, M=253, R=249, D=502) at beam
    40, U=16; C layouts against the mirror, times, bounds, workspace
    bytes; (b) at beam 10 the workspace instance gives the resident
    instance's bits (``instance=``), both timed; (c)
    wsj_jan_wsj13v2.yaml's (L=400, a 266-step cap) and wsj_pyramide.yaml's
    (D=2000) decodes of 16 utterances of 600-800 frames through
    ``beam_search`` at beam 10: the workspace instance launches (not the
    resident one nor the energy kernel), the plain loop's outputs, the
    module route's best hypotheses under ``use_pallas: never``, more than
    half of them with a symbol besides EOS, the seconds of the three;
    (d) ``run_search`` on the flagship with decode.sh's no-LM settings
    (beam 200, char_discount 0.1, the median window's ``before`` 10) over
    16 utterances in one chunk: the workspace instance launches once, the
    report agrees with the module route's (``use_pallas: never``), utt/s
    of both, then beam 513 takes the module route; (e) the resident loop
    instances on phases 3, 20b, 22a and 23a's main paths hash to the bits
    of the tree before the workspace instances (``RESIDENT_LOOP_BITS``),
    their times; (f), run first: the workspace instances' one-pass
    selection against the resident instances' K rounds on adversarial
    grids (ties, +-0.0, rows at INF and BIG) at K 1-512, bit for bit.
    25a's comparison lets at most two utterances a case differ by swaps
    of near-equal done-set entries, each swap logged with both routes'
    slots, costs and ulps; a swap of bit-equal costs fails.
26. the recipe tools on the card: (a) a word trigram in ARPA text from a
    seed (60 words of 2-8 letters, 150 bigrams, 150 trigrams, ``<s>``,
    ``</s>``, ``<UNK>``) and the network's characters; (b)
    ``exp/wsj/make_lm_graph.sh``'s steps (``arpa2fst``,
    ``arpa-to-unigram``, ``arpa-to-dict``, ``create-lexicon``, ``pack``,
    ``build-lg``) as processes of ``python -m
    attention_lvcsr_torch.cli.lm_tools``, each step's seconds and
    LG_pushed's states logged, any nonzero exit fatal, and
    ``LG_pushed.fst.txt`` with its ``.syms`` packed again to
    ``LG_pushed.npz``'s tables; (c) ``run_search`` with decode.sh's LM
    settings on that graph (weight 0.5, no_transition_cost 20,
    char_discount 1.0, ``net.prior.before`` 10, the graph's ``words.txt``
    as the vocabulary) at beam 10 over phase 18's 16 recordings, with
    transcripts of the LM's words, in one chunk, on the kernels and on the
    plain route (the decode's ``gru_scan`` and energies plain, the
    analyses on the training kernels on both) on the same random weights
    (the EOS logit not raised: the graph ends each hypothesis on one of
    its words): the same hypotheses, beam search costs within phase 8's
    tolerance, the rest as phase 18 compares reports, ``gru_scan`` and
    ``beam_attention_energies`` launched and the loop kernel not, at most
    half of the hypotheses empty; (d) ``python -m
    attention_lvcsr_torch.cli.score`` on ``decoded_save``'s file (mapped
    to words by ``tools/decoded_chars_to_words.py``) gives each
    utterance the report's WER, and the report's average is rebuilt from
    them; the phase's seconds.
27. the training services on the card, on wsj_paper.yaml's flagship
    network at full width (random weights from seed 1234; B=32, 800
    frames, 100 labels, as phase 13) with ``regularization.dropout`` and
    ``regularization.noise`` 0.01: (a) one step's draws from
    ``noise_generator``, the noised set the non-attention parameters and
    the mask keeping 0.5 +- 0.02; the cost and gradients with those draws
    on the kernels and on the plain route (encoder outputs and attention
    weights within 1e-5, gradients within 1e-4 of their largest value,
    the bottom output equal), the step on the kernels whose
    ``train_cost`` and ``total_gradient_norm`` are within 1e-4 relative
    of the plain route's; (b) a four-batch ``run_stage`` of the same
    settings, given through ``make_config_changes``, with
    ``monitoring.plot`` (``path``, ``serve``, port 0), ``NanGuard``,
    ``ProgressBar``, ``TorchProfiler`` over batches 2-3 and an
    extension after the server that fetches ``/data.json``, the batches
    made in a ``MultiProcessStream`` worker: ``code_version`` and the
    compile statistics in the status, ``plot.json`` and ``/data.json``
    holding the log's four ``train_cost`` values, the Chrome trace naming
    the GRU training and decoder kernels, no "not ported" warning, and
    the same per-step ``train_cost`` bits as a run on the direct stream;
    (c) a step with a NaN parameter: ``NanGuard`` raises
    ``FloatingPointError`` naming the field and iteration 1; (d) the
    native host DP built from ``csrc/host/lvsr_native.cpp`` into
    ``build/host/``: ``batch_reward_and_gain`` at B=32, 100 labels, 32
    symbols gives the numpy rows' integers, both timed; the phase's
    seconds.
28. the model variants no recipe uses, at the flagship's widths (random
    weights from seed 1234), each on the kernels JAX's route takes and
    against the plain route: (a) ``dims_top: [500]`` with one-hot
    feedback (``embed_outputs: false``, the loop kernel's F = A = 33): the
    loop kernel against the plain loop at U=64, 800 frames, beam 10, a
    100-step cap, the EOS logit raised (``VARIANT_EOS_BIAS``: a random
    model's hypotheses must finish), the decode through
    ``beam_search`` (``gru_scan`` and ``beam_search_loop`` launched, as
    phase 4 compares), two training steps (the GRU training scans,
    ``decoder_scan_train``, ``outer_sum``) against one on the plain route
    (phase 13's tolerance); (b) the LSTM decoder: the module decode at
    U=16 (``gru_scan`` and ``beam_attention_energies``, not the loop
    kernel), the energies kernel timed at that decode's operands, a
    dictionary-constrained decode under ``use_pallas: fused``
    (``fused_decode_score``), two training steps (no
    ``decoder_scan_train``) against the plain route; (c) a simple-RNN
    encoder and decoder: the module decode at U=16
    (``beam_attention_energies`` only) and one training step (no kernel,
    as in JAX); (d) ``prototype_autoencoder.yaml``, read through the port's
    config loader (``autoencoder_config``; a lookup bottom, content
    attention, the states in the readout) on a seeded copy task: four
    batches of ten through ``run_stage`` and a search over 16 utterances through ``run_search`` (the EOS logit +1.0,
    char_discount 4.0), on the kernels and on the plain route: per-batch
    ``train_cost`` within phase 13's tolerance, the reports as phase 18
    compares them, at least half the hypotheses non-empty, and
    ``gru_scan_train_bidir``, ``decoder_scan_train`` (its content branch)
    and ``gru_scan`` timed at the prototype's shapes; each part's seconds
    and launches.
29. the quality proxy (``attention_lvcsr_torch/cli/quality_proxy.py``) at
    its ``fast`` tier from seed 7, the data in memory (``--in-memory``:
    the tool's ``ArrayDataset`` through ``Data``): the synthetic language,
    its ARPA and ``LG_pushed``; the model trained through
    ``train_multistage`` on the kernels for ``QUALITY_EPOCHS``, each
    stage's first step held against the plain route from the same start
    (train_cost and total_gradient_norm within 1e-4 relative); the
    decodes of ``QUALITY_DECODES`` from the trained checkpoint through
    the tool's ``decode_and_score`` (no LM and LM-fused at beams 10 and
    20, no LM at beam 200 over one batch of 16, which at these widths
    takes the loop kernel's workspace instance) on the kernels and on the
    plain route: each
    batch's outputs as ``compare_outputs`` compares them (reordered done
    sets allowed), the same CER, WER and empty count, more than half of
    the hypotheses non-empty; ``gru_scan_train_bidir``,
    ``decoder_scan_train``, ``outer_sum``, ``gru_scan``, both loop
    instances and ``beam_attention_energies`` launched; the seconds of
    the build, the training, the decodes and the plain route.

Nothing of JAX or of the JAX package is imported; the script checks it.

The second line from the end is a JSON object describing each kernel:
its times, its bound (``bound_ms``: the larger of its bytes over the
card's memory rate and its float32 operations over the card's peak,
computed from this run's shapes) and ``library_ms`` (null where no
PyTorch call computes the function; for ``outer_sum``, one cuBLAS
``addmm_`` per job; ``search_launches``, the launches of phase 18's paths
a-d that run the kernel; ``multistage_launches``, phase 19's kernel-route
run of the three stages; ``timit_launches``, phase 20c-d's kernel route;
``content``, for ``beam_search_loop`` and ``decoder_scan_train``, the
content branch's times, bound and errors at phase 20's shapes;
``mse_logistic`` and ``relu`` for the loop, ``logistic`` and ``relu`` for
the decoder, phase 21's branches; ``task_loss_launches``, phase 21e's
kernel route; ``maxout10_mean``, ``maxout10_expanding``, ``rectifier``,
``sigmoid`` and ``identity`` for the loop, ``filters10_mean_B10`` and
``_B32`` for the decoder and ``mean`` for the score step, phase 22a-c's
branches; ``variant_launches``, phase 22d's kernel route per recipe;
``stack2_mean``, ``stack2_expanding``, ``stack2_S512``, ``stack3_S64``,
``stack4_S64`` and ``stack2_debug`` for the loop, ``stack2_B10``,
``stack2_B32``, ``stack2_S512_B10``, ``stack3_S64_B10`` and
``stack4_S64_B10`` for the decoder, phase 23a-b's stacked decoders;
``stacked_launches``, phase 23c-d's kernel route per recipe;
``gru_scan_wide`` and ``gru_scan_train_bidir_wide``, the wide instances'
rows at D=1000 with D=500 beside them, phase 24a-b;
``pyramide_launches``, phase 24c-d's kernel route;
``beam_search_loop_ws``, the workspace instance's row at beam 200 with
phase 25a's other beams and 25b's resident and workspace times at beam
10 beside it; ``workspace_launches``, phase 25c-d's kernel route;
``recipe_launches``, phase 26c's kernel route; ``services_launches``,
phase 27b's kernel route; ``top_onehot`` for the loop, ``lstm_decoder_U16``
for the energies and ``autoencoder`` for ``gru_scan``,
``gru_scan_train_bidir`` and ``decoder_scan_train``, phase 28's shapes;
``variant_model_launches``, phase 28's kernel routes per variant and
path; ``quality_launches``, phase 29's kernel route);
the line before it holds the rates, phase 21d's reward DP time and
launches among them; the last
is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository around it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np


def log(msg):
    print(msg, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def cuda_ms(fn, repeats):
    """Mean device time of ``fn`` over ``repeats`` calls (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def graph_ms(fn, repeats):
    """Device time of one call of ``fn``: ``repeats`` calls captured in a
    CUDA graph and replayed, timed with CUDA events, so that the wrapper's
    host time between launches is not counted (a kernel of tens of
    microseconds launches faster than its Python wrapper returns)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(repeats):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * repeats)


@contextlib.contextmanager
def swapped(pairs):
    """Replace ``module.name`` by ``value`` for each (module, name, value)
    inside the block: how the plain path is driven end to end."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in pairs]
    for m, n, v in pairs:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


FLAGSHIP_INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.1],
                                 "biases_init": ["constant", 0.0],
                                 "rec_weights_init": ["orthogonal"]}}
CHARS = [chr(ord("a") + i) for i in range(26)] + [
    "<spc>", "'", ".", "-", "<bol>", "<eol>"]
CHAR_MAP = {c: i for i, c in enumerate(CHARS)}


def word_trigram_arpa():
    """A word trigram in ARPA text, made from seed 26: 60 words of 2-8
    letters of ``CHARS``, 150 bigrams and 150 trigrams over them, ``<s>``,
    ``</s>`` and ``<UNK>`` (log10 probabilities and backoffs; every
    trigram's history is a bigram).  Returns (text, words)."""
    rng = np.random.RandomState(26)
    letters = CHARS[:26]
    words = set()
    while len(words) < 60:
        words.add("".join(rng.choice(letters, size=rng.randint(2, 9))))
    words = sorted(words)
    prob = lambda: round(float(-0.3 - 1.5 * rng.rand()), 4)
    uni = {("<s>",): (-99.0, prob()), ("</s>",): (prob(), None),
           ("<UNK>",): (prob(), prob())}
    for w in words:
        uni[(w,)] = (prob(), prob())
    firsts, seconds = ["<s>", "<UNK>"] + words, ["</s>", "<UNK>"] + words
    bi = {}
    while len(bi) < 150:
        gram = (firsts[rng.randint(len(firsts))],
                seconds[rng.randint(len(seconds))])
        bi.setdefault(gram, (prob(), prob()))
    histories = sorted(g for g in bi if g[1] != "</s>")
    tri = {}
    while len(tri) < 150:
        a, b = histories[rng.randint(len(histories))]
        tri.setdefault((a, b, seconds[rng.randint(len(seconds))]),
                       (prob(), None))
    lines = ["\\data\\"] + [f"ngram {n}={len(g)}"
                            for n, g in ((1, uni), (2, bi), (3, tri))]
    for n, grams in ((1, uni), (2, bi), (3, tri)):
        lines += ["", f"\\{n}-grams:"]
        for gram, (p, bo) in grams.items():
            lines.append(" ".join([str(p), *gram]
                                  + ([] if bo is None else [str(bo)])))
    return "\n".join(lines + ["", "\\end\\", ""]), words


def bench_trigram(path):
    """The WSJ-shaped character trigram of ``bench.py`` (seed 11, 31
    characters + E over the 32 network ids), packed dense to ``path``."""
    from attention_lvcsr_torch.ops import fst as F
    rng = np.random.RandomState(11)
    toks = [f"c{i}" for i in range(31)] + ["E"]
    uni = {("<s>",): (-99.0, -0.4), ("</s>",): (-1.5, 0.0)}
    for t in toks:
        uni[(t,)] = (float(-1.2 - rng.rand()), -0.5)
    bi, tri = {}, {}
    for a in toks:
        for b in toks:
            bi[(a, b)] = (float(-0.8 - rng.rand()), -0.3)
    for a in toks:
        for b in toks:
            for c in rng.choice(len(toks), size=3, replace=False):
                tri[(a, b, toks[c])] = (float(-0.5 - rng.rand()), 0.0)
    graph = F.arpa_to_fst({1: uni, 2: bi, 3: tri},
                          {t: i + 1 for i, t in enumerate(toks)})
    packed = F.pack_fst(graph, {i: i + 1 for i in range(len(toks))},
                        num_nn_symbols=32, no_transition_cost=20.0)
    F.save_packed(path, packed)
    return graph.num_states


def best_hypotheses(out):
    """Per utterance: (labels tuple, cost) of the best valid hypothesis."""
    best = []
    for u in range(out["done_valid"].shape[0]):
        valid = out["done_valid"][u]
        if not valid.any():
            best.append(((), None))
            continue
        k = int(np.argmin(np.where(valid, out["done_adjusted"][u], np.inf)))
        n = int(out["done_len"][u, k])
        best.append((tuple(int(x) for x in out["done_out"][u, k, :n]),
                     float(out["done_cost"][u, k])))
    return best


def ulps(a, b):
    """Distance in float32 units in the last place between a and b."""
    ia, ib = (int(np.float32(x).view(np.int32)) for x in (a, b))
    ia, ib = (i if i >= 0 else -(i & 0x7FFFFFFF) for i in (ia, ib))
    return abs(ia - ib)


def swapped_pairs(got, ref, u, close):
    """The swaps that turn the kernel's done set of utterance ``u`` into
    the plain version's: each pair of hypotheses that both hold in the
    other order (slot and adjusted cost on each route), and each
    hypothesis that only one holds beside the one it displaced (the
    routes' unmatched entries paired in cost order).  Returns (pairs,
    faults): a pair is a fault when its two costs are not within the
    tolerance on either route, or when the order differs though each
    route computed both costs bit for bit as the other did, or found
    them bit-equal (a tie, which both order by flat index); so is a
    hypothesis both hold whose costs differ past the tolerance."""
    def entries(out):
        valid = out["done_valid"][u]
        return [(tuple(int(x) for x in out["done_out"][u, k,
                                                      :out["done_len"][u, k]]),
                 int(k), np.float32(out["done_adjusted"][u, k]),
                 np.float32(out["done_cost"][u, k]))
                for k in np.nonzero(valid)[0]]
    g_all, r_all = entries(got), entries(ref)
    r_by = {}
    for e in r_all:
        r_by.setdefault(e[0], []).append(e)
    common, g_only = [], []
    for e in g_all:
        if r_by.get(e[0]):
            common.append((e, r_by[e[0]].pop(0)))
        else:
            g_only.append(e)
    r_only = [e for es in r_by.values() for e in es]
    pairs, faults = [], []
    for ga, ra in common:
        if not (close(ga[2], ra[2]) and close(ga[3], ra[3])):
            faults.append({"labels": ga[0], "kernel": (float(ga[2]),
                                                       float(ga[3])),
                           "plain": (float(ra[2]), float(ra[3]))})
    for i, (ga, ra) in enumerate(common):
        for gb, rb in common[i + 1:]:
            if (ga[1] < gb[1]) == (ra[1] < rb[1]):
                continue
            pair = {"labels": (ga[0], gb[0]), "slots_kernel": (ga[1], gb[1]),
                    "slots_plain": (ra[1], rb[1]),
                    "adjusted_kernel": (float(ga[2]), float(gb[2])),
                    "adjusted_plain": (float(ra[2]), float(rb[2])),
                    "ulps_kernel": ulps(ga[2], gb[2]),
                    "ulps_plain": ulps(ra[2], rb[2])}
            pairs.append(pair)
            same_bits = ga[2] == ra[2] and gb[2] == rb[2]
            tied = ga[2] == gb[2] and ra[2] == rb[2]
            if same_bits or tied or not (close(ga[2], gb[2])
                                         and close(ra[2], rb[2])):
                faults.append(pair)
    for ge, re_ in zip(sorted(g_only, key=lambda e: e[2]),
                       sorted(r_only, key=lambda e: e[2])):
        pair = {"labels": (ge[0], re_[0]), "slots_kernel": (ge[1], None),
                "slots_plain": (None, re_[1]),
                "adjusted_kernel": (float(ge[2]), None),
                "adjusted_plain": (None, float(re_[2])),
                "ulps_across": ulps(ge[2], re_[2])}
        pairs.append(pair)
        if not close(ge[2], re_[2]):
            faults.append(pair)
    if len(g_only) != len(r_only):
        faults.append({"unpaired": (len(g_only), len(r_only))})
    return pairs, faults


def compare_outputs(name, got, ref, reorder=False):
    """Kernel vs plain decode outputs, utterance by utterance: finished
    hypotheses, lengths, validity and step counts identical, costs within
    1e-4 + 1e-5 relative.  At most one utterance may differ, and only as a
    near tie: the costs of the two best hypotheses within 1e-3 relative.
    With ``reorder`` (phase 25a's wide beams, whose done sets of up to 512
    entries hold many costs closer than the two routes' rounding), an
    utterance whose steps, number of finished hypotheses and best
    hypothesis are the plain version's, and whose done set differs from it
    only by swaps of entries within the tolerance of each other
    (``swapped_pairs``: each pair logged with both routes' slots, adjusted
    costs and their distance in ulps), counts as reordered, apart from the
    near ties; a swap of bit-equal costs is a tie-order fault and fails,
    and so do more than two reordered utterances.  ``steps`` is per
    utterance, or one number for the batch.  Returns the max abs cost
    error over the finished hypotheses that agree."""
    per_utt_steps = np.ndim(ref["steps"]) == 1
    best_g, best_r = best_hypotheses(got), best_hypotheses(ref)
    differ, reordered, err = [], [], 0.0
    close = lambda a, b: bool(np.all(np.abs(a - b) <= 1e-4 + 1e-5 * np.abs(b)))
    for u in range(len(best_r)):
        valid = ref["done_valid"][u]
        cost_g = np.stack([got["done_cost"][u], got["done_adjusted"][u]])
        cost_r = np.stack([ref["done_cost"][u], ref["done_adjusted"][u]])
        same_steps = not per_utt_steps or got["steps"][u] == ref["steps"][u]
        if (np.array_equal(got["done_out"][u], ref["done_out"][u])
                and np.array_equal(got["done_len"][u], ref["done_len"][u])
                and np.array_equal(got["done_valid"][u], valid)
                and same_steps and close(cost_g, cost_r)):
            if valid.any():
                err = max(err, float(np.abs(cost_g - cost_r)[:, valid].max()))
            continue
        (lab_g, c_g), (lab_r, c_r) = best_g[u], best_r[u]
        valid_g = got["done_valid"][u]
        if (reorder and same_steps and valid_g.sum() == valid.sum()
                and lab_g == lab_r and c_g is not None and c_r is not None
                and close(np.float32(c_g), np.float32(c_r))
                and close(np.sort(cost_g[:, valid_g], axis=1),
                          np.sort(cost_r[:, valid], axis=1))):
            pairs, faults = swapped_pairs(got, ref, u, close)
            for pair in pairs:
                log(f"{name}: utterance {u} swaps {json.dumps(pair)}")
            if faults:
                fail(f"{name}: utterance {u}'s done set differs by swaps "
                     f"that are no rounding: {json.dumps(faults)}")
            reordered.append(u)
            log(f"{name}: utterance {u}'s done set reorders near-equal "
                f"entries ({len(pairs)} swaps of {valid.sum()} entries; "
                f"best {lab_g} ({c_g}) both)")
            continue
        if c_g is None or c_r is None or \
                abs(c_g - c_r) > 1e-3 * max(abs(c_r), 1.0):
            fail(f"{name}: utterance {u} differs: best {lab_g} ({c_g}) vs "
                 f"plain {lab_r} ({c_r})")
        differ.append(u)
        log(f"{name}: near tie at utterance {u}: costs {c_g} vs {c_r}; "
            f"labels {lab_g} vs {lab_r}")
    if len(differ) > 1:
        fail(f"{name}: {len(differ)} utterances differ (at most one near tie "
             f"allowed): {differ}")
    if len(reordered) > 2:
        fail(f"{name}: {len(reordered)} utterances reorder their done sets "
             f"(at most two allowed): {reordered}")
    if not per_utt_steps and not differ and got["steps"] != ref["steps"]:
        fail(f"{name}: {got['steps']} steps vs plain {ref['steps']}")
    return err


def counts(counters):
    return {name: c.count for name, c in counters.items()}


# Published peaks of one H100 SXM (NVIDIA's data sheet, at the 700 W
# limit): HBM3 bytes per second, and float32 operations per second outside
# the tensor cores, where every kernel of the port does its arithmetic.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


def bound(nbytes, ops):
    """The least time the card could take for a function: the larger of
    its bytes (each input read once, each output written once) over the
    memory rate and its float32 operations over the peak rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    if t_bytes >= t_ops:
        return {"bound_ms": t_bytes, "bound_by": "bytes"}
    return {"bound_ms": t_ops, "bound_by": "operations"}


def nbytes(*tensors):
    """Bytes of the tensors (dicts of tensors count their values)."""
    total = 0
    for x in tensors:
        if isinstance(x, dict):
            total += nbytes(*x.values())
        elif x is not None:
            total += x.numel() * x.element_size()
    return total


def gru_step_ops(D):
    """Operations of one GRU step of one row: the gate and candidate
    products (2 * 3D * D) and about a dozen elementwise ones per unit."""
    return 6 * D * D + 12 * D


def attention_step_ops(S, M, L, conv, D):
    """Operations of one attention step of one row: the state's keys
    (2SM), the convolution (2 * L * conv, conv = taps or L for a Toeplitz
    band), the match (add, handler, tanh, energy: 6LM; content attention,
    conv = 0, has no handler term: 4LM), the softmax (4L) and the weighted
    average (2LD)."""
    match = (6 if conv else 4) * L * M
    return 2 * S * M + 2 * L * conv + match + 4 * L + 2 * L * D


def readout_ops(D, R, V):
    """Merge, tanh, post-merge layer and log-softmax of one row."""
    return 2 * D * R + R + 2 * R * V + 3 * V


def relative_errors(got, ref):
    """Per name: max abs error over the reference's max abs value."""
    return {name: float((got[name] - ref[name]).abs().max()
                        / ref[name].abs().max().clamp_min(1e-30))
            for name in ref}


def serve_check(phase, transcriber, launched, idle, max_batch=8):
    """8 concurrent requests against ``make_server``: each answer equals
    the direct decode of that request alone; every counter in
    ``launched`` moves, none in ``idle`` does."""
    from attention_lvcsr_torch.serve import make_server
    server = make_server(transcriber, "127.0.0.1", 0, max_batch=max_batch,
                         batch_wait_ms=50.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        srng = np.random.RandomState(3)
        reqs = [srng.randn(int(n), 123).astype(np.float32)
                for n in srng.randint(300, 801, size=8)]
        host, port = server.server_address
        answers, errors = {}, []

        def client(i):
            buf = io.BytesIO()
            np.save(buf, reqs[i])
            req = urllib.request.Request(
                f"http://{host}:{port}/decode", data=buf.getvalue(),
                headers={"Content-Type": "application/octet-stream"})
            try:
                with urllib.request.urlopen(req, timeout=300) as resp:
                    answers[i] = json.loads(resp.read())
            except Exception as exc:     # reported below
                errors.append(f"request {i}: {exc}")

        for c in list(launched.values()) + list(idle.values()):
            c.reset()
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
        wall = time.perf_counter() - t0
        if errors or len(answers) != 8:
            fail(f"{phase}: {errors or 'missing answers'}")
        moved, still = counts(launched), counts(idle)
        if min(moved.values()) < 1 or any(still.values()):
            fail(f"{phase}: launches {moved}, expected none of {still}")
        for i, feats_i in enumerate(reqs):
            direct = transcriber.transcribe_batch([feats_i])[0]
            got = answers[i]
            costs = (got["cost"], direct["cost"])
            if got["labels"] != direct["labels"] or (
                    None in costs and costs[0] != costs[1]) or (
                    None not in costs and abs(costs[0] - costs[1])
                    > 1e-4 * max(1.0, abs(costs[1]))):
                fail(f"{phase}: request {i} answered {got} but the direct "
                     f"decode gives {direct}")
        finished = sum(a["cost"] is not None for a in answers.values())
        log(f"{phase}: 8 concurrent requests answered in {wall:.3f} s, "
            f"equal to the direct decode ({finished} with a finished "
            f"hypothesis); launches {moved}")
    finally:
        server.batcher.close()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def timed_decodes(decode, n):
    """(last output, per-call seconds) of ``n`` synchronised decodes."""
    times, out = [], None
    for _ in range(n):
        t0 = time.perf_counter()
        out = decode()
        times.append(time.perf_counter() - t0)
    return out, times


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a GPU")
    try:
        import __graft_entry__  # noqa: F401  (the flagship's shapes)
        from attention_lvcsr_torch import _build
    except ImportError as exc:
        fail(f"{exc}: run this script from the root of the repository")

    run_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip())     # the card's name and power limit
    dev = torch.device("cuda:0")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    results, launches, rates = {}, {}, {}
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)

    # ---- 1. build --------------------------------------------------------
    lib = _build.load()
    log(f"phase 1 build: {lib.build_seconds:.1f} s -> {lib.path}")
    for line in lib.log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    marks = [time.perf_counter()]
    rec = decode_phases(t, dev, results, launches, rates)
    marks.append(time.perf_counter())
    gru_train_phase(t, dev, results)
    decoder_train_phase(t, dev, results)
    train_step_phase(t, dev, launches, rates)
    marks.append(time.perf_counter())
    frontend_phase(t, dev, results)
    waveform_serve_phase(dev, rec, launches)
    marks.append(time.perf_counter())
    lstm_phase(t, dev, results)
    lstm_model_phase(t, dev, launches, rates)
    marks.append(time.perf_counter())
    log("phases 2-10 {:.1f} s, 11-13 {:.1f} s, 14-15 {:.1f} s, 16-17 {:.1f} "
        "s".format(*np.diff(marks)))
    t0 = time.perf_counter()
    search_launches = search_phase(t, dev, launches, rates)
    log(f"phase 18: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    stage_launches = multistage_phase(t, dev, rates)
    log(f"phase 19: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    timit_launches = timit_phase(t, dev, results, rates)
    log(f"phase 20: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    task_loss_launches = task_loss_phase(t, dev, results, rates)
    log(f"phase 21: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    variant_launches = wsj_variants_phase(t, dev, results, rates)
    log(f"phase 22: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    stacked_launches = stacked_phase(t, dev, results, rates)
    log(f"phase 23: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pyramide_launches = pyramide_phase(t, dev, results, rates)
    log(f"phase 24: {time.perf_counter() - t0:.1f} s")
    # the wide instances' main paths: the recipe's training (24c) and its
    # serve decode (24d)
    launches["gru_scan_wide"] = pyramide_launches["wsj_pyramide serve"][
        "gru_scan_wide"]
    launches["gru_scan_train_bidir_wide"] = pyramide_launches[
        "wsj_pyramide train"]["gru_scan_train_bidir_wide"]
    t0 = time.perf_counter()
    workspace_launches = workspace_phase(t, dev, results, rates)
    log(f"phase 25: {time.perf_counter() - t0:.1f} s")
    # the workspace instance's main path: run.py search at decode.sh's
    # beam 200 (25d)
    launches["beam_search_loop_ws"] = workspace_launches["wide search"][
        "beam_search_loop_ws"]
    recipe_launches = recipe_phase(t, dev, rates)
    services_launches = services_phase(t, dev, rates)
    variant_model_launches = variants_phase(t, dev, results, rates)
    t0 = time.perf_counter()
    quality_launches = quality_phase(dev, rates)
    log(f"phase 29: {time.perf_counter() - t0:.1f} s")

    banned = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "attention_lvcsr_tpu"))
    if banned:
        fail(f"JAX or the JAX package was imported: {banned}")
    pallas = "attention_lvcsr_tpu/ops/pallas/"
    sources = {
        "gru_scan": ("gru_scan.cu", "gru_scan.py:72"),
        "beam_search_loop": ("beam_loop.cu", "beam_loop.py:638"),
        # the workspace instances (beams past a block, long inputs)
        "beam_search_loop_ws": ("beam_loop_ws.cu", "beam_loop.py:638"),
        "beam_attention_energies": ("attention_energy.cu",
                                    "attention_energy.py:59"),
        "fused_decode_score": ("decode_score.cu", "decode_score.py:168"),
        "gru_scan_train": ("gru_train.cu", "gru_train.py:291"),
        "gru_scan_train_bidir": ("gru_train.cu", "gru_train.py:570"),
        # the wide instances (D above 448 forward, 384 backward)
        "gru_scan_wide": ("gru_scan.cu", "gru_scan.py:72"),
        "gru_scan_train_bidir_wide": ("gru_train.cu", "gru_train.py:570"),
        "decoder_scan_train": ("decoder_train.cu", "decoder_train.py:839"),
        "fbank_deltas": ("frontend.cu", "frontend.py:180"),
        "lstm_scan": ("lstm_scan.cu", "lstm_train.py:324"),
        "lstm_scan_train": ("lstm_train.cu", "lstm_train.py:374"),
        # the weight-gradient sums inside the TPU backward kernels; the
        # flagship's is the bidirectional GRU backward's
        "outer_sum": ("outer_sum.cu", "gru_train.py:529")}
    kernels = [dict({"name": name, "route": "cuda",
                     "source": f"attention_lvcsr_torch/csrc/{src}",
                     "replaces": pallas + tpu, "launches": launches[name]},
                    **results[name])
               for name, (src, tpu) in sources.items()]
    for k in kernels:
        # phase 18's launches, per search path (a-d) that runs the kernel
        k["search_launches"] = {
            path.split(":")[0]: n for path, n in search_launches.items()
            if path.split(":")[1] == k["name"]}
        if k["name"] in stage_launches:
            k["multistage_launches"] = stage_launches[k["name"]]
        # phase 20c-d's kernel route: the TIMIT recipe's stages and search
        k["timit_launches"] = timit_launches.get(k["name"], 0)
        # phase 21e's kernel route: iclr_reward.yaml's two stages
        k["task_loss_launches"] = task_loss_launches.get(k["name"], 0)
        # phase 22d's kernel route, per recipe
        k["variant_launches"] = {recipe: moved.get(k["name"], 0)
                                 for recipe, moved in
                                 variant_launches.items()}
        # phase 23c-d's kernel route, per recipe: the stacked decoders
        k["stacked_launches"] = {recipe: moved.get(k["name"], 0)
                                 for recipe, moved in
                                 stacked_launches.items()}
        # phase 24c-d's kernel route: wsj_pyramide.yaml's training and
        # serve decode
        k["pyramide_launches"] = {path: moved.get(k["name"], 0)
                                  for path, moved in
                                  pyramide_launches.items()}
        # phase 25c-d's kernel route: the long decodes and run_search at
        # beam 200
        k["workspace_launches"] = {path: moved.get(k["name"], 0)
                                   for path, moved in
                                   workspace_launches.items()}
        # phase 26c's kernel route: run_search on the graph the port's
        # command line built
        k["recipe_launches"] = recipe_launches.get(k["name"], 0)
        # phase 27b's kernel route: a run_stage with the training services
        k["services_launches"] = services_launches.get(k["name"], 0)
        # phase 28's kernel routes, per variant and path: the model
        # variants no recipe uses
        k["variant_model_launches"] = {
            part: moved.get(k["name"], 0)
            for part, moved in variant_model_launches.items()}
        # phase 29's kernel route: the quality proxy's training and decodes
        k["quality_launches"] = quality_launches.get(k["name"], 0)
    log(f"all phases: {time.perf_counter() - run_start:.1f} s")
    log(json.dumps(dict(rates, build_s=lib.build_seconds)))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def gru_scan_plans(t, dev, rng, T, D, result):
    """Phase 2, last: the forward kernel's C layout against the Python
    mirror, the clusters of 8 and 16 blocks the card holds at once, the
    cluster size the launcher takes, and the kernel's time at the serving
    sizes B=128 and 256 (both directions, full mask)."""
    import ctypes
    import torch
    from attention_lvcsr_torch import _build
    from attention_lvcsr_torch.ops import gru_scan as gs
    lib = _build.load().lib
    lib.gru_scan_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    for size in gs.CLUSTERS:
        mirror = gs.fwd_layout(D, size)["smem_bytes"]
        if lib.gru_scan_smem_bytes(D, size) != mirror:
            fail(f"gru_scan: the C layout of {size}-block clusters has "
                 f"{lib.gru_scan_smem_bytes(D, size)} bytes, the mirror "
                 f"{mirror}")
    for B in (32, 64, 128, 256):
        plan = gs.launch_plan(D, B, 2, dev)
        log(f"phase 2 gru_scan plan B={B} D={D}, both directions: "
            f"{plan['clusters']} clusters of {plan['cluster']} blocks; the "
            f"card holds at once {plan['active'][16]} 16-block and "
            f"{plan['active'][8]} 8-block clusters "
            f"({gs.fwd_layout(D, 16)['smem_bytes']} and "
            f"{gs.fwd_layout(D, 8)['smem_bytes']} bytes a block)")
        result[f"cluster_B{B}"] = plan["cluster"]
    result["max_active_clusters"] = gs.max_active_clusters(D, dev)
    for B in (128, 256):
        proj = t(rng.randn(T, B, 6 * D) * 0.5)
        mask = torch.ones(T, B, device=dev)
        weights = [(t(rng.randn(B, D) * 0.1),
                    t(rng.randn(D, D) / np.sqrt(D)),
                    t(rng.randn(D, 2 * D) / np.sqrt(D))) for _ in range(2)]
        result[f"ms_B{B}"] = cuda_ms(
            lambda: gs.gru_scan(proj, mask, *weights), 3)
        log(f"  kernel at B={B}: {result[f'ms_B{B}']:.3f} ms")


def beam_loop_plan(dims, content=False, normalizer="softmax", phase=None,
                   n_filters=1, post_act=0, maxout=0, dec_stack=1,
                   instance="resident"):
    """Phases 3, 20b, 21b, 22a, 23a and 25: the loop kernel's C layout
    against its Python mirror at the main path's shape (``dims`` carries
    the C struct's ``content`` flag for the content branch;
    ``n_filters``, ``post_act``, ``maxout`` and ``dec_stack`` the struct's
    filters, activation and decoder layers): the resident instance's
    block bytes, or the workspace instance's block bytes and workspace
    floats an utterance (``instance="workspace"``)."""
    import ctypes
    from attention_lvcsr_torch import _build
    from attention_lvcsr_torch.ops import beam_loop as bl
    lib = _build.load().lib
    names = (("beam_loop_smem_bytes",) if instance == "resident"
             else ("beam_loop_ws_smem_bytes", "beam_loop_ws_stride"))
    args = bl._Args(U=1, normalizer=bl.NORMALIZERS.index(normalizer),
                    n_filters=n_filters, post_act=post_act, maxout=maxout,
                    dec_stack=dec_stack, **dims)
    c_values = []
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(bl._Args)]
        fn.restype = ctypes.c_int
        c_values.append(fn(ctypes.byref(args)))
    plan = bl.smem_plan(**{k: v for k, v in dims.items() if k != "content"},
                        content=content, normalizer=normalizer,
                        n_filters=n_filters, maxout=maxout,
                        dec_stack=dec_stack)
    mirror = plan if instance == "resident" else plan["workspace"]
    want = [mirror["smem_bytes"]] + (
        [] if instance == "resident" else [mirror["stride"]])
    if c_values != want or not mirror["fits"]:
        fail(f"beam_search_loop {instance}: the C layout gives {c_values} "
             f"(bytes a block, workspace floats), the mirror {want} (fits: "
             f"{mirror['fits']}; content {content}, {normalizer})")
    log(f"phase {phase or ('20b' if content else '3')} beam_loop {instance} "
        f"layout ({normalizer}, {n_filters} filters, post_act {post_act}, "
        f"{dec_stack} layers): {c_values[0]} bytes a block"
        + ("" if instance == "resident" else
           f", {4 * c_values[1]} workspace bytes an utterance")
        + " (C equals the mirror)")
    if instance == "resident":
        return {"smem_bytes": c_values[0]}
    return {"smem_bytes": c_values[0], "workspace_stride": c_values[1]}


def score_layouts(dev):
    """Phase 7: the score kernel's C layout (``decode_score_smem_bytes``)
    against its Python mirror at the flagship widths on clusters of 1, 2,
    4 and 8 blocks, and at other beams and widths (up to the widest window
    one block holds); the clusters of each size the card holds at once and
    the size the launcher takes at U=1-256."""
    import ctypes
    from attention_lvcsr_torch import _build
    from attention_lvcsr_torch.ops import decode_score as ds
    fn = _build.load().lib.decode_score_smem_bytes
    fn.argtypes = [ctypes.POINTER(ds._Args)]
    fn.restype = ctypes.c_int
    checked = 0
    for K, L, M, D, S, R, V, taps in ((10, 200, 250, 500, 250, 250, 32, 201),
                                      (3, 37, 40, 24, 20, 30, 12, 7),
                                      (12, 201, 251, 502, 253, 249, 33, 9),
                                      (1, 5, 7, 9, 3, 2, 5, 3),
                                      (16, 400, 250, 500, 250, 250, 32, 201),
                                      (10, 1437, 250, 500, 250, 250, 32, 201),
                                      (10, 1606, 250, 500, 250, 250, 32, 201),
                                      (36, 200, 250, 500, 250, 250, 32, 201)
                                      ):
        for cluster in (1, 2, 4, 8):
            args = ds._Args(L=L, M=M, D=D, S=S, R=R, V=V, K=K, n_taps=taps,
                            cluster=cluster)
            mirror = ds.smem_layout(K, L, M, D, S, R, V, taps,
                                    cluster)["bytes"]
            if fn(ctypes.byref(args)) != mirror:
                fail(f"decode_score layout: C gives {fn(ctypes.byref(args))}"
                     f" bytes, the mirror {mirror} (K={K} L={L} M={M} D={D} "
                     f"cluster={cluster})")
            checked += 1
    shape = dict(K=10, L=200, M=250, D=500, S=250, R=250, V=32, n_taps=201)
    flagship = [ds.smem_layout(cluster=c, **shape)["bytes"]
                for c in (1, 2, 4, 8)]
    sizes = {u: ds.launch_plan(u, shape, dev)["cluster"]
             for u in (1, 8, 16, 17, 32, 33, 64, 66, 67, 128, 256)}
    log(f"phase 7 decode_score layout: C equals the mirror in {checked} "
        f"shapes; flagship bytes a block on clusters of 1, 2, 4, 8: "
        f"{flagship}; clusters the card holds at once "
        f"{ds.active_clusters(shape, dev)}; cluster size at U: {sizes}")


def decode_phases(t, dev, results, launches, rates):
    """Phases 2-10: the serving kernels and the three decodes."""
    import torch
    from __graft_entry__ import FLAGSHIP_NET
    from attention_lvcsr_torch.models import attention as attention_mod
    from attention_lvcsr_torch.models import cells as cells_mod
    from attention_lvcsr_torch.models import generator as generator_mod
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from attention_lvcsr_torch.ops import attention_energy as ae
    from attention_lvcsr_torch.ops import beam_loop as bl
    from attention_lvcsr_torch.ops import decode_score as ds
    from attention_lvcsr_torch.ops import gru_scan as gs
    from attention_lvcsr_torch.search import beam as beam_mod
    from attention_lvcsr_torch.search.beam import DecodeConstraint
    from attention_lvcsr_torch.serve import Transcriber

    # ---- 2. gru_scan -----------------------------------------------------
    # the encoder's first layer: both directions in one launch
    rng = np.random.RandomState(0)
    T, B, D = 800, 64, 250
    lengths = rng.randint(300, T + 1, size=B)
    lengths[0] = T
    proj = t(rng.randn(T, B, 6 * D) * 0.5)
    mask = t((np.arange(T)[:, None] < lengths[None, :]).astype(np.float32))
    weights = [(t(rng.randn(B, D) * 0.1), t(rng.randn(D, D) / np.sqrt(D)),
                t(rng.randn(D, 2 * D) / np.sqrt(D))) for _ in range(2)]
    args = (proj, mask, *weights)
    got = gs.gru_scan(*args)
    ref = gs.gru_scan_reference(*args)
    one = gs.gru_scan(proj[..., :3 * D].contiguous(), mask, weights[0])
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    err_one = float((one - ref[..., :D]).abs().max())
    log(f"phase 2 gru_scan T={T} B={B} D={D}, both directions: max abs err "
        f"{err:.3e} (one direction alone: {err_one:.3e})")
    if not max(err, err_one) <= 1e-4:
        fail(f"gru_scan disagrees with its plain version: {err}, {err_one}")
    if not torch.equal(got, gs.gru_scan(*args)):
        fail("gru_scan: a second call gave other bits")
    results["gru_scan"] = {
        "max_abs_err": max(err, err_one),
        "ms": cuda_ms(lambda: gs.gru_scan(*args), 5),
        "plain_ms": cuda_ms(lambda: gs.gru_scan_reference(*args), 2),
        **bound(nbytes(proj, mask, *[w for d in weights for w in d], got),
                2 * T * B * gru_step_ops(D)),
        "library_ms": None}
    log(f"  kernel {results['gru_scan']['ms']:.3f} ms, plain "
        f"{results['gru_scan']['plain_ms']:.3f} ms; a second call repeats "
        f"bit for bit")
    gru_scan_plans(t, dev, rng, T, D, results["gru_scan"])

    # ---- 3. beam_search_loop ---------------------------------------------
    net_config = dict(FLAGSHIP_NET, max_decoded_length_scale=8.0)
    rec = SpeechRecognizer(net_config, init_config=FLAGSHIP_INIT, seed=1234,
                           device=dev)
    rec.init_beam_search(10)
    prior = rec.net.generator.attention.prior_config()
    loop_err = 0.0
    for U, frames, eos_bias in ((8, 400, 0.0), (64, 800, 0.0),
                                (64, 800, 1.5)):
        feats = t(np.random.RandomState(1).randn(U, frames, 123))
        fmask = torch.ones(U, frames, device=dev)
        with torch.inference_mode():
            data = rec.net.decode_loop(feats, fmask)
            tables = dict(rec.net.decode_loop_tables())
        tables["post_b"] = tables["post_b"].clone()
        tables["post_b"][rec.eos_label] += eos_bias
        kw = dict(beam=10, max_len=int(frames / 8.0), eol=rec.eos_label,
                  ignore_first_eol=rec.data_prepend_eos,
                  prior=prior["type"], before=float(prior["before"]),
                  after=float(prior["after"]))
        loop_args = (data["pre"], data["attended"], data["attended_mask"],
                     tables)

        def as_out(res):
            out, meta, steps = (r.cpu().numpy() for r in res)
            return {"done_out": out, "done_cost": meta[:, :, 0],
                    "done_adjusted": meta[:, :, 1],
                    "done_len": meta[:, :, 2].astype(np.int32),
                    "done_valid": meta[:, :, 1] < bl.INF / 2,
                    "steps": steps}

        got = as_out(bl.beam_search_loop(*loop_args, **kw))
        ref = as_out(bl.beam_search_loop_reference(*loop_args, **kw))
        name = f"beam_search_loop U={U} eos_bias={eos_bias}"
        err = compare_outputs(name, got, ref)
        loop_err = max(loop_err, err)
        finished = int(got["done_valid"].any(axis=1).sum())
        log(f"phase 3 {name} frames={frames}: outputs agree; {finished}/{U} "
            f"utterances and {int(got['done_valid'].sum())}/{U * 10} slots "
            f"finished, steps {int(got['steps'].min())}.."
            f"{int(got['steps'].max())}, max abs cost err {err:.3e}")
        if eos_bias and finished < U * 3 // 4:
            fail(f"{name}: only {finished}/{U} utterances finished: the "
                 f"comparison is too weak")
        if (U, frames, eos_bias) == (64, 800, 0.0):
            S, L = rec.net.generator.dim_dec, data["pre"].shape[1]
            M, D = data["pre"].shape[2], data["attended"].shape[2]
            R, V = 250, rec.num_phonemes
            plan = beam_loop_plan(dict(
                K=10, L=L, M=M, D=D, S=S, R=R, V=V,
                F=tables["embed"].shape[1], Lout=kw["max_len"],
                n_taps=tables["conv_filters"].shape[-1]))
            widths = []             # each step's window, for the bound
            bl.beam_search_loop_reference(*loop_args, **kw,
                                          window_widths=widths)
            ops, window = loop_ops(net_config, 10, D, widths, got["steps"])
            loop_out = bl.beam_search_loop(*loop_args, **kw)
            results["beam_search_loop"] = {
                "ms": cuda_ms(lambda: bl.beam_search_loop(*loop_args, **kw),
                              3),
                "plain_ms": cuda_ms(
                    lambda: bl.beam_search_loop_reference(*loop_args, **kw),
                    1),
                **bound(nbytes(*loop_args[:3], tables, *loop_out), ops),
                "mean_window": window, "library_ms": None, **plan}
    results["beam_search_loop"]["max_abs_err"] = loop_err
    log(f"  kernel {results['beam_search_loop']['ms']:.3f} ms, plain "
        f"{results['beam_search_loop']['plain_ms']:.3f} ms, bound "
        f"{results['beam_search_loop']['bound_ms']:.3f} ms over windows of "
        f"{results['beam_search_loop']['mean_window']:.1f} frames on average "
        f"(U=64, main path's tables)")

    # ---- 4. full decode through the recognizer -----------------------------
    Bd, Td = 64, 800
    feats_np = np.random.RandomState(2).randn(Bd, Td, 123).astype(np.float32)
    feats = torch.tensor(feats_np, device=dev)
    fmask = torch.ones(Bd, Td, device=dev)
    plain_encoder = (cells_mod, "gru_scan", gs.gru_scan_reference)

    def decoder(recognizer, **kwargs):
        def decode():
            out = recognizer.beam_search(feats, fmask, as_arrays=True,
                                         **kwargs)
            torch.cuda.synchronize()
            return out
        return decode

    decode = decoder(rec)
    gs.launches.reset()
    bl.launches.reset()
    out = decode()
    launches.update(gru_scan=gs.launches.count,
                    beam_search_loop=bl.launches.count)
    log(f"phase 4 launches in one decode: {launches}")
    if min(launches.values()) < 1:
        fail(f"a kernel of the main path never launched: {launches}")
    if out["done_out"].shape != (Bd, 10, Td // 8) or not np.isfinite(
            out["done_cost"][out["done_valid"]]).all():
        fail("decode output has the wrong shape or non-finite costs")
    _, times = timed_decodes(decode, 5)
    rates["decode_utt_per_s"] = Bd / statistics.median(times)
    with swapped([plain_encoder, (beam_mod, "beam_search_loop",
                                  bl.beam_search_loop_reference)]):
        out_plain, ptimes = timed_decodes(decode, 2)
    rates["plain_decode_utt_per_s"] = Bd / statistics.median(ptimes)
    decode_err = compare_outputs("decode", out, out_plain)
    log(f"phase 4 decode B={Bd} frames={Td} beam=10 steps="
        f"{int(out['steps'])}: kernel path {rates['decode_utt_per_s']:.2f} "
        f"utt/s (median of 5, {[round(x, 4) for x in times]} s), plain path "
        f"{rates['plain_decode_utt_per_s']:.2f} utt/s; outputs agree (max "
        f"abs cost err {decode_err:.3e})")

    # ---- 5. serve -----------------------------------------------------------
    serve_check("phase 5 serve",
                Transcriber(rec, char_map=CHAR_MAP, beam_size=10),
                {"gru_scan": gs.launches, "beam_search_loop": bl.launches},
                {})

    # ---- 6. beam_attention_energies ----------------------------------------
    # the LM decode's shape at U=64, then U=128 and 256
    U, K, L, M = 64, 10, 200, 250
    energy = {}
    for Ue in (64, 128, 256):
        erng = np.random.RandomState(6)
        eargs = (t(erng.randn(Ue, L, M)), t(erng.randn(Ue * K, M)),
                 t(erng.randn(Ue * K, L) * 0.1), t(erng.randn(M) * 0.1),
                 t(erng.randn(M) * 0.1))
        got = ae.beam_attention_energies(*eargs, 0.0, beam=K)
        ref = ae.beam_attention_energies_reference(*eargs, 0.0, beam=K)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if not err <= 1e-4:
            fail(f"beam_attention_energies disagrees with its plain version "
                 f"at U={Ue}: {err}")
        if not torch.equal(got, ae.beam_attention_energies(*eargs, 0.0,
                                                           beam=K)):
            fail(f"beam_attention_energies: a second call at U={Ue} gave "
                 f"other bits")
        energy[Ue] = {
            "max_abs_err": err,
            "ms": graph_ms(lambda: ae.beam_attention_energies(
                *eargs, 0.0, beam=K), 50),
            "plain_ms": cuda_ms(lambda: ae.beam_attention_energies_reference(
                *eargs, 0.0, beam=K), 10),
            **bound(nbytes(*eargs, got), 6 * Ue * K * L * M),
            "library_ms": None}
        log(f"phase 6 beam_attention_energies U={Ue} K={K} L={L} M={M}: "
            f"plan {ae.launch_plan(Ue, K, L, M, dev)}; max abs err "
            f"{err:.3e}, a second call repeats its bits; kernel "
            f"{energy[Ue]['ms']:.4f} ms, plain {energy[Ue]['plain_ms']:.4f} "
            f"ms, bound {energy[Ue]['bound_ms']:.5f} ms")
    results["beam_attention_energies"] = dict(
        energy[64], max_abs_err=max(e["max_abs_err"]
                                    for e in energy.values()))

    # ---- 7. fused_decode_score ----------------------------------------------
    srng = np.random.RandomState(7)
    slen = srng.randint(400, Td + 1, size=U)
    smask = t((np.arange(Td)[None] < slen[:, None]).astype(np.float32))
    with torch.inference_mode():
        ctx = rec.net.decode_contexts(feats[:U], smask)
        tables = rec.net.generator.fused_score_tables()
        start = rec.net.decode_init(U * K, ctx)
    L = ctx["attended"].shape[1]
    logits = srng.randn(U * K, L) * 3.0
    later_w = np.exp(logits - logits.max(axis=1, keepdims=True))
    later_w /= later_w.sum(axis=1, keepdims=True)
    states_later = {
        "initial": (start["glimpses"]["weights"], start["glimpses"]["step"],
                    start["states"]),
        "later": (t(later_w), torch.full((U * K,), 37, dtype=torch.int32,
                                         device=dev),
                  t(np.tanh(srng.randn(U * K, rec.net.generator.dim_dec))))}
    priors = {"window_around_median": dict(before=prior["before"],
                                           after=prior["after"]),
              "expanding": dict(initial_begin=10.0, initial_end=120.0,
                                min_speed=0.5, max_speed=1.5)}
    score_err = 0.0
    for pname, pkw in priors.items():
        kw = dict(beam=K, prior=pname,
                  **{k: float(v) for k, v in pkw.items()})
        for sname, (w0, step0, h0) in states_later.items():
            sargs = (ctx["preprocessed"], ctx["attended"],
                     ctx["attended_mask"], w0.contiguous(),
                     step0.contiguous(), h0.contiguous(), tables)
            got = ds.fused_decode_score(*sargs, **kw)
            ref = ds.fused_decode_score_reference(*sargs, **kw)
            torch.cuda.synchronize()
            errs = {n: float((g - r).abs().max()) for n, g, r in zip(
                ("costs", "weights", "energies", "wa"), got, ref)}
            log(f"phase 7 fused_decode_score {pname} from the {sname} "
                f"glimpses: max abs err {errs}")
            if not max(errs.values()) <= 1e-4:
                fail(f"fused_decode_score disagrees with its plain version: "
                     f"{pname} {sname} {errs}")
            if not all(torch.equal(g, a) for g, a in zip(
                    got, ds.fused_decode_score(*sargs, **kw))):
                fail(f"fused_decode_score: a second call gave other bits "
                     f"({pname}, {sname})")
            score_err = max(score_err, *errs.values())
    score_layouts(dev)
    skw = dict(beam=K, prior="window_around_median",
               before=float(prior["before"]), after=float(prior["after"]))
    ekw = dict(beam=K, prior="expanding",
               **{k: float(v) for k, v in priors["expanding"].items()})
    score = {}
    for Us in (1, 16, 64, 128, 256):
        if Us == U:
            sctx, w_s = ctx, later_w
            steps_s, h_s = states_later["later"][1], states_later["later"][2]
        else:
            urng = np.random.RandomState(Us)
            ulen = urng.randint(400, Td + 1, size=Us)
            umask = t((np.arange(Td)[None] < ulen[:, None]).astype(
                np.float32))
            with torch.inference_mode():
                sctx = rec.net.decode_contexts(
                    t(urng.randn(Us, Td, 123)), umask)
            ul = urng.randn(Us * K, L) * 3.0
            w_s = np.exp(ul - ul.max(axis=1, keepdims=True))
            w_s /= w_s.sum(axis=1, keepdims=True)
            steps_s = torch.full((Us * K,), 37, dtype=torch.int32,
                                 device=dev)
            h_s = t(np.tanh(urng.randn(Us * K, rec.net.generator.dim_dec)))
        sargs = (sctx["preprocessed"], sctx["attended"],
                 sctx["attended_mask"], t(w_s), steps_s, h_s, tables)
        for kw in (skw, ekw):
            got = ds.fused_decode_score(*sargs, **kw)
            ref = ds.fused_decode_score_reference(*sargs, **kw)
            torch.cuda.synchronize()
            err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            if not err <= 1e-4:
                fail(f"fused_decode_score disagrees with its plain version "
                     f"at U={Us} ({kw['prior']}): {err}")
            if not all(torch.equal(g, a) for g, a in zip(
                    got, ds.fused_decode_score(*sargs, **kw))):
                fail(f"fused_decode_score: a second call at U={Us} gave "
                     f"other bits ({kw['prior']})")
            score_err = max(score_err, err)
        out = ds.fused_decode_score(*sargs, **skw)
        score[Us] = {
            "max_abs_err": score_err,
            "ms": graph_ms(lambda: ds.fused_decode_score(*sargs, **skw), 50),
            "plain_ms": cuda_ms(lambda: ds.fused_decode_score_reference(
                *sargs, **skw), 10),
            **bound(nbytes(*sargs[:6], tables, *out),
                    Us * K * (attention_step_ops(
                        rec.net.generator.dim_dec,
                        sctx["preprocessed"].shape[2], L, 2 * 100 + 1,
                        sctx["attended"].shape[2])
                        + readout_ops(sctx["attended"].shape[2], 250,
                                      rec.num_phonemes))),
            "library_ms": None}
        expanding_ms = graph_ms(lambda: ds.fused_decode_score(*sargs,
                                                              **ekw), 50)
        plan = ds.launch_plan(Us, dict(
            K=K, L=L, M=sargs[0].shape[2], D=sargs[1].shape[2],
            S=rec.net.generator.dim_dec, R=tables["merge_k"].shape[1],
            V=tables["post_k"].shape[1],
            n_taps=tables["conv_filters"].shape[-1]), dev)
        log(f"phase 7 fused_decode_score U={Us} K={K} L={L}: plan "
            f"{plan}; both priors agree with the plain "
            f"version and repeat their bits; kernel "
            f"{score[Us]['ms']:.4f} ms (median prior, a later step; "
            f"expanding {expanding_ms:.4f} ms), plain "
            f"{score[Us]['plain_ms']:.4f} ms, bound "
            f"{score[Us]['bound_ms']:.5f} ms")
    results["fused_decode_score"] = dict(score[64], max_abs_err=score_err)

    # ---- 8. LM-fused decode --------------------------------------------------
    counters = {"gru_scan": gs.launches, "beam_search_loop": bl.launches,
                "beam_attention_energies": ae.launches,
                "fused_decode_score": ds.launches}
    with tempfile.TemporaryDirectory() as tmp:
        lm_path = os.path.join(tmp, "lm_trigram.npz")
        n_states = bench_trigram(lm_path)
        rec_lm = SpeechRecognizer(
            dict(net_config, lm={"path": lm_path, "weight": 0.5,
                                 "no_transition_cost": 20.0}),
            init_config=FLAGSHIP_INIT, seed=1234, device=dev)
    rec_lm.init_beam_search(10)
    decode_lm = decoder(rec_lm, char_discount=1.0)
    for c in counters.values():
        c.reset()
    out = decode_lm()
    moved = counts(counters)
    launches["beam_attention_energies"] = moved["beam_attention_energies"]
    log(f"phase 8 LM trigram {n_states} states; launches in one LM-fused "
        f"decode: {moved}")
    if moved["gru_scan"] < 1 or moved["beam_attention_energies"] < 1 \
            or moved["beam_search_loop"]:
        fail(f"LM-fused decode did not run through its kernels: {moved}")
    if out["done_out"].shape != (Bd, 10, Td) or not np.isfinite(
            out["done_cost"][out["done_valid"]]).all():
        fail("LM decode output has the wrong shape or non-finite costs")
    _, times = timed_decodes(decode_lm, 3)
    rates["lm_decode_utt_per_s"] = Bd / statistics.median(times)
    plain_lm = [plain_encoder, (attention_mod, "beam_attention_energies",
                                ae.beam_attention_energies_reference)]
    with swapped(plain_lm):
        out_plain, ptimes = timed_decodes(decode_lm, 1)
    rates["plain_lm_decode_utt_per_s"] = Bd / statistics.median(ptimes)
    lm_err = compare_outputs("LM decode", out, out_plain)
    log(f"phase 8 LM decode B={Bd} frames={Td} beam=10 char_discount=1.0 "
        f"steps={int(out['steps'])}: kernel path "
        f"{rates['lm_decode_utt_per_s']:.2f} utt/s (median of 3, "
        f"{[round(x, 4) for x in times]} s), plain path "
        f"{rates['plain_lm_decode_utt_per_s']:.2f} utt/s; outputs agree, "
        f"{int(out['done_valid'].sum())} slots finished (max abs cost err "
        f"{lm_err:.3e})")
    post_b = rec_lm.net.generator.readout.post_merge_0.bias
    post_b.data[rec_lm.eos_label] += 1.5
    out = decode_lm()
    with swapped(plain_lm):
        out_plain = decode_lm()
    lm_err = max(lm_err, compare_outputs("LM decode, EOS +1.5", out,
                                         out_plain))
    finished = int(out["done_valid"].any(axis=1).sum())
    log(f"phase 8 LM decode with the EOS logit +1.5: outputs agree; "
        f"{finished}/{Bd} utterances finished, steps {int(out['steps'])}")
    if finished < 1:
        fail("LM decode with the EOS logit raised finished nothing: the "
             "comparison is too weak")
    post_b.data[rec_lm.eos_label] -= 1.5

    # ---- 9. constrained decode through fused_decode_score -------------------
    wrng = np.random.RandomState(9)
    words = sorted({"".join(wrng.choice(CHARS[:26], size=wrng.randint(2, 8)))
                    for _ in range(300)})
    constraint = DecodeConstraint.from_words(words, CHAR_MAP, 32)
    rec_c = SpeechRecognizer(dict(net_config, use_pallas="fused"),
                             init_config=FLAGSHIP_INIT, seed=1234, device=dev)
    rec_c.net.generator.readout.post_merge_0.bias.data[rec_c.eos_label] += 1.5
    rec_c.init_beam_search(10)
    decode_c = decoder(rec_c, char_discount=1.0,
                       validate_solution_function=constraint)
    for c in counters.values():
        c.reset()
    out = decode_c()
    moved = counts(counters)
    launches["fused_decode_score"] = moved["fused_decode_score"]
    log(f"phase 9 lexicon of {len(words)} words, constraint "
        f"{constraint.trans.shape[0]} states; launches in one constrained "
        f"decode: {moved}")
    if moved["fused_decode_score"] < 1 or moved["gru_scan"] < 1:
        fail(f"constrained decode did not run through its kernels: {moved}")
    n_checked = 0
    for u, k in zip(*np.nonzero(out["done_valid"])):
        tokens = [int(x) for x in out["done_out"][u, k, :out["done_len"][u, k]]]
        body = tokens[:-1]
        if rec_c.data_prepend_eos and body and body[0] == rec_c.eos_label:
            body = body[1:]
        state = 0
        for sym in body:
            state = int(constraint.trans[state, sym])
            if state < 0:
                break
        if state < 0 or tokens[-1] != rec_c.eos_label \
                or not constraint.final[state]:
            fail(f"constrained decode: utterance {u} slot {k} finished with "
                 f"{tokens}, which the constraint rejects")
        n_checked += 1
    if n_checked < 1:
        fail("constrained decode finished nothing: the check is too weak")
    _, times = timed_decodes(decode_c, 3)
    rates["constrained_decode_utt_per_s"] = Bd / statistics.median(times)
    with swapped([plain_encoder, (generator_mod, "fused_decode_score",
                                  ds.fused_decode_score_reference)]):
        out_plain, ptimes = timed_decodes(decode_c, 1)
    rates["plain_constrained_decode_utt_per_s"] = Bd / statistics.median(
        ptimes)
    c_err = compare_outputs("constrained decode", out, out_plain)
    log(f"phase 9 constrained decode B={Bd} frames={Td} beam=10 "
        f"steps={int(out['steps'])}: {n_checked} finished hypotheses, all "
        f"accepted by the constraint; kernel path "
        f"{rates['constrained_decode_utt_per_s']:.2f} utt/s (median of 3), "
        f"plain path {rates['plain_constrained_decode_utt_per_s']:.2f} "
        f"utt/s; outputs agree (max abs cost err {c_err:.3e})")

    # ---- 10. serve with the LM ----------------------------------------------
    # one request per batch: the module-driven decode takes its attention
    # window over the whole batch (as the JAX package's does), so a
    # request's answer equals its direct decode only when it decodes alone
    serve_check("phase 10 serve with the LM",
                Transcriber(rec_lm, char_map=CHAR_MAP, beam_size=10,
                            search_kwargs={"char_discount": 1.0}),
                {"gru_scan": gs.launches,
                 "beam_attention_energies": ae.launches},
                {"beam_search_loop": bl.launches}, max_batch=1)

    rates["lm_decode_max_abs_cost_err"] = lm_err
    return rec


def grads_of(fn, leaves, cots):
    """Outputs of ``fn(*leaves)`` and the gradients of every leaf under
    the cotangents ``cots`` (one per differentiable output)."""
    import torch
    xs = [x.detach().requires_grad_() for x in leaves]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = torch.autograd.grad(outs[:len(cots)], xs, cots)
    return [o.detach() for o in outs], grads


def repeat(name, grads, again):
    """The kernels' gradients of a second call equal the first's bit for
    bit: every sum in them is taken in a fixed order."""
    import torch
    if not all(torch.equal(g, h) for g, h in zip(grads, again[1])):
        fail(f"{name}: a second call gave other gradients")


def backward_ms(fn, leaves, cots, repeats):
    """Device time of the backward pass alone: the graph is built once and
    its gradient taken ``repeats`` times."""
    import torch
    xs = [x.detach().requires_grad_() for x in leaves]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return cuda_ms(lambda: torch.autograd.grad(
        outs[:len(cots)], xs, cots, retain_graph=True), repeats)


def gru_train_phase(t, dev, results):
    """Phase 11: gru_scan_train's forward and backward kernels vs the plain
    version (autograd through the plain scan), the flagship encoder's
    first layer: T=800, B=32, D=250, ragged mask, random cotangent."""
    rng = np.random.RandomState(11)
    T, B, D = 800, 32, 250
    lengths = rng.randint(300, T + 1, size=B)
    lengths[0] = T
    mask = t((np.arange(T)[:, None] < lengths[None, :]).astype(np.float32))
    for ndir, name in ((1, "gru_scan_train"), (2, "gru_scan_train_bidir")):
        results[name] = gru_train_case(t, rng, mask, D, ndir, "11", name)
    outer_sum_check(t, rng, results, T, B, D)


def gru_train_case(t, rng, mask, D, ndir, phase, name):
    """gru_scan_train's forward and backward kernels at width D over
    ``ndir`` directions and the (T, B) ``mask`` against the plain version
    (autograd through the plain scan) under a random cotangent: states
    within 1e-5, every gradient within 1e-4 of its largest value, a
    second call bit for bit; the times, the backward kernel's alone, and
    the bounds.  Returns the result."""
    from attention_lvcsr_torch.ops import gru_train as gt
    T, B = mask.shape
    proj = t(rng.randn(T, B, 3 * D * ndir) * 0.5)
    dirs = [(t(rng.randn(B, D) * 0.1), t(rng.randn(D, D) / np.sqrt(D)),
             t(rng.randn(D, 2 * D) / np.sqrt(D))) for _ in range(ndir)]
    cots = [t(rng.randn(T, B, D * ndir))]
    leaves = [proj] + [w for d in dirs for w in d]

    def scan(fn):
        return lambda p, *w: fn(p, mask, tuple(w[:3]),
                                tuple(w[3:]) if ndir == 2 else None)

    (got,), ggot = grads_of(scan(gt.gru_scan_train), leaves, cots)
    (ref,), gref = grads_of(scan(gt.gru_scan_train_reference), leaves, cots)
    named = lambda out, g: dict(
        {"states": out},
        **{f"{part}[{i}]": g[0][..., 3 * D * i + a:3 * D * i + b]
           for i in range(ndir)
           for part, a, b in (("dx_in", 0, D), ("dx_gate", D, 3 * D))},
        **{f"{part}[{i}]": g[1 + 3 * i + k] for i in range(ndir)
           for k, part in enumerate(("dh0", "dW_ss", "dW_sg"))})
    errs = relative_errors(named(got, ggot), named(ref, gref))
    state_err = float((got - ref).abs().max())
    log(f"phase {phase} {name} T={T} B={B} D={D}: states max abs err "
        f"{state_err:.3e}; gradients, max abs err over max abs value: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()
                    if k != "states"))
    # states: f32 in another summation order, |h| < 1 (1e-5 absolute);
    # gradients: sums over the reverse recurrence and, for the weights,
    # over T*B rows in another order (1e-4 of their scale)
    if not (state_err <= 1e-5
            and max(v for k, v in errs.items() if k != "states") <= 1e-4):
        fail(f"{name} disagrees with its plain version")
    repeat(name, ggot, grads_of(scan(gt.gru_scan_train), leaves, cots))
    fwd = scan(gt.gru_scan_train)
    plain = scan(gt.gru_scan_train_reference)
    fwd_ms = cuda_ms(lambda: fwd(*leaves), 3)
    bwd_ms = backward_ms(fwd, leaves, cots, 3)
    plain_fwd = cuda_ms(lambda: plain(*leaves), 1)
    plain_bwd = backward_ms(plain, leaves, cots, 1)
    kernel_ms = gru_backward_kernel_ms(proj, mask, dirs, cots[0], 3)
    # forward: the projections, mask, weights in; states and the three
    # residuals out.  Backward: cotangent, states, residuals, mask and
    # weights in; the projections' and weights' gradients out; twice
    # the forward's products (state gradient, weight gradients)
    weights = [w for d in dirs for w in d]
    fwd_bytes = nbytes(proj, mask, *weights) + 4 * nbytes(got)
    bwd_bytes = 5 * nbytes(got) + nbytes(mask, *weights, proj) \
        + nbytes(*weights)
    ops = ndir * T * B * gru_step_ops(D)
    result = {
        "max_abs_err": max(state_err, *[
            float((a - b).abs().max()) for a, b in zip(ggot, gref)]),
        "ms": fwd_ms + bwd_ms, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
        "bwd_kernel_ms": kernel_ms,
        "bwd_kernel_us_per_step": kernel_ms * 1e3 / T,
        "plain_ms": plain_fwd + plain_bwd, "plain_fwd_ms": plain_fwd,
        "plain_bwd_ms": plain_bwd,
        **bound(fwd_bytes + bwd_bytes, 3 * ops),
        "fwd_bound_ms": bound(fwd_bytes, ops)["bound_ms"],
        "bwd_bound_ms": bound(bwd_bytes, 2 * ops)["bound_ms"],
        "library_ms": None}
    log(f"  kernels: forward {fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms "
        f"(of which gru_train.cu's kernel {kernel_ms:.3f} ms, "
        f"{kernel_ms * 1e3 / T:.2f} us a step); plain: forward "
        f"{plain_fwd:.3f} ms, backward {plain_bwd:.3f} ms; bound "
        f"{result['bound_ms']:.3f} ms")
    return result


def gru_backward_kernel_ms(proj, mask, dirs, cot, repeats):
    """Device time of gru_train.cu's backward kernel alone (no outer_sum,
    no copies), on the forward kernel's states and residuals."""
    import torch
    from attention_lvcsr_torch import _build
    from attention_lvcsr_torch.ops import gru_scan as gs
    from attention_lvcsr_torch.ops import gru_train as gt
    T, B, _ = proj.shape
    D, ndir = dirs[0][1].shape[0], len(dirs)
    out = torch.empty(T, B, D * ndir, device=proj.device)
    residuals = [tuple(torch.empty(T, B, D, device=proj.device)
                       for _ in range(3)) for _ in range(ndir)]
    gs.launch(proj, mask, dirs, out, residuals, "gru_scan_train")
    dproj = torch.empty(T, B, 3 * D * ndir, device=proj.device)
    dh0s = [torch.empty(B, D, device=proj.device) for _ in range(ndir)]
    stream = _build.stream_of(proj)
    return cuda_ms(lambda: gt.launch_backward(
        cot, out, mask, dirs, residuals, dproj, dh0s, stream), repeats)


def outer_sum_check(t, rng, results, T, B, D):
    """Phase 11, last: outer_sum.cu vs its plain version on the four jobs
    of the flagship bidirectional GRU layer's backward (per direction:
    dW_ss from h_prev * r and dx_in, dW_sg from h_prev and dx_gate, over
    T*B rows, dx_in and dx_gate column slices of one (T, B, 6D) tensor),
    and one cuBLAS ``addmm_`` per job beside them."""
    import torch
    from attention_lvcsr_torch.ops import outer_sum as osum
    dproj = t(rng.randn(T, B, 6 * D))
    h_prev = [t(rng.randn(T, B, D) * 0.5) for _ in range(2)]
    r = [t(rng.rand(T, B, D)) for _ in range(2)]
    zeros = lambda *s: torch.zeros(*s, device=dproj.device)

    def jobs(flat=False):
        rows = (lambda x: x.view(T * B, x.shape[-1])) if flat else \
            (lambda x: x)
        d = dproj.view(T * B, 6 * D) if flat else dproj
        return [job for i in range(2) for job in (
            (rows(h_prev[i]), rows(r[i]), d[..., 3 * D * i:3 * D * i + D],
             zeros(D, D)),
            (rows(h_prev[i]), None, d[..., 3 * D * i + D:3 * D * (i + 1)],
             zeros(D, 2 * D)))]

    got, again, ref = jobs(), jobs(), jobs()
    osum.outer_sum(got, dproj)
    osum.outer_sum(again, dproj)
    osum.outer_sum_plain(ref)
    torch.cuda.synchronize()
    if any(not torch.equal(g[3], h[3]) for g, h in zip(got, again)):
        fail("outer_sum: a second call gave other bits")
    err = max(float((g[3] - p[3]).abs().max()) for g, p in zip(got, ref))
    rel = max(float((g[3] - p[3]).abs().max() / p[3].abs().max())
              for g, p in zip(got, ref))
    log(f"phase 11 outer_sum, 4 jobs over {T * B} rows (D={D}): max abs err "
        f"{err:.3e}, {rel:.2e} of the largest value; a second call repeats "
        f"bit for bit")
    # f32 sums over 25600 rows in another order: 1e-5 of their scale
    if not rel <= 1e-5:
        fail(f"outer_sum disagrees with its plain version: {rel}")
    flat = jobs(flat=True)

    def library():
        for a, a2, b, c in flat:
            c.addmm_((a if a2 is None else a * a2).T, b)

    ops = sum(2 * T * B * c.shape[0] * c.shape[1]
              + (T * B * c.shape[0] if a2 is not None else 0)
              for _, a2, _, c in got)
    results["outer_sum"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: osum.outer_sum(got, dproj), 10),
        "plain_ms": cuda_ms(lambda: osum.outer_sum_plain(ref), 10),
        # inputs a, a2, b and c read once, c written once
        **bound(nbytes(*h_prev, *r, dproj) + 2 * nbytes(
            *[c for *_, c in got]), ops),
        "library_ms": cuda_ms(library, 10)}
    log(f"  kernels {results['outer_sum']['ms']:.3f} ms, plain "
        f"{results['outer_sum']['plain_ms']:.3f} ms, one addmm_ per job "
        f"{results['outer_sum']['library_ms']:.3f} ms, bound "
        f"{results['outer_sum']['bound_ms']:.3f} ms")


def decoder_operands(t, dev, rng, T=100, B=32, L=200, M=250, D=500, S=250,
                     taps=201, N=1):
    """Flagship-shaped operands of decoder_scan_train, ragged label and
    frame masks (row 0 full: the expanding prior counts its steps); ``N``
    GRU layers lane-stacked, with the interlayer tables of a stack."""
    import torch
    from attention_lvcsr_torch.ops.decoder_train import toeplitz_band
    f = lambda *s, scale=1.0: t(rng.randn(*s) * scale)
    labels = rng.randint(T // 2, T + 1, size=B)
    labels[0] = T
    frames = rng.randint(L // 2, L + 1, size=B)
    frames[0] = L
    w0 = torch.zeros(B, L, device=dev)
    w0[:, 0] = 1.0
    NS = N * S
    ops = dict(
        fx=f(T, B, NS), fg=f(T, B, 2 * NS), pre=f(B, L, M, scale=0.5),
        attended=f(B, L, D, scale=0.5), h0=f(B, NS, scale=0.1),
        wa0=torch.zeros(B, D, device=dev),
        toep=toeplitz_band(f(1, taps, scale=0.1), L),
        st=f(NS, M, scale=0.1), hand=f(1, M, scale=0.1),
        v=f(M, scale=0.1), wss=f(S, NS, scale=1 / np.sqrt(S)),
        wsg=f(S, 2 * NS, scale=1 / np.sqrt(S)), dxm=f(D, NS, scale=0.05),
        dgm=f(D, 2 * NS, scale=0.05))
    if N > 1:
        ops.update(inter_in=f(S, (N - 1) * S, scale=1 / np.sqrt(S)),
                   inter_gate=f(S, 2 * (N - 1) * S, scale=1 / np.sqrt(S)))
    fixed = dict(
        mask=t((np.arange(T)[:, None] < labels[None]).astype(np.float32)),
        att_mask=t((np.arange(L)[None] < frames[:, None]).astype(
            np.float32)),
        w0=w0)
    cots = [f(T, B, NS), f(T, B, L), f(T, B, D)]
    return ops, fixed, cots


@contextlib.contextmanager
def timed_launches(module, repeats, times):
    """Inside the block, every launch through ``module._launch`` runs
    ``repeats`` more times between CUDA events, on the same operands, and
    ``times[name]`` gets its mean device time: a kernel's time alone (the
    launch counters count the wrapper's calls, not these)."""
    import torch
    launch = module._launch

    def timed(name, args, stream_of):
        launch(name, args, stream_of)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            launch(name, args, stream_of)
        end.record()
        torch.cuda.synchronize()
        times[name] = start.elapsed_time(end) / repeats

    module._launch = timed
    try:
        yield times
    finally:
        module._launch = launch


def decoder_plans(dev, dims):
    """Phase 12, first: the two kernels' launch plans at B=32 and 64 (the
    clusters the card holds at once, the clusters, rows a cluster, rows
    whose tiles stay in shared memory) and the C layout against its Python
    mirror over a spread of shapes and plans."""
    import ctypes
    from attention_lvcsr_torch import _build
    from attention_lvcsr_torch.ops import decoder_train as dt
    lib = _build.load().lib
    lib.decoder_train_smem_bytes.argtypes = [ctypes.c_int,
                                             ctypes.POINTER(dt._Args)]
    lib.decoder_train_smem_bytes.restype = ctypes.c_int
    checked = 0
    # the conv branch with one filter and with ten, the content branch
    for kind, content, nf in ((k, c, f) for k in dt.KINDS
                              for c, f in ((0, 1), (0, 10), (1, 0))):
        for B, L, M, D, S in ((32, 200, 250, 500, 250), (64, 200, 250, 500,
                                                         250),
                              (16, 175, 250, 500, 250),
                              (3, 199, 33, 17, 33), (132, 10, 7, 9, 5)):
            for C in dt.CLUSTERS:
                for n in {1, min(B, 7)}:
                    R = -(-B // n)
                    for res in ((0, 0, 0), (R, R, R), (1, 0, R), (0, R, 1),
                                (R // 2, 1, 0)):
                        res = dict(zip(("pre", "att", "dpre"), res))
                        args = dt._Args(B=B, L=L, M=M, D=D, S=S, cluster=C,
                                        clusters=n, content=content,
                                        n_filters=nf,
                                        **{f"res_{k}": v for k, v in
                                           res.items()})
                        got = lib.decoder_train_smem_bytes(
                            dt.KINDS.index(kind), ctypes.byref(args))
                        if kind == "forward":
                            res["dpre"] = 0
                        want = dt.layout(kind, C, R, L, M, D, S, res,
                                         n_filters=nf)["smem_bytes"]
                        if got != want:
                            fail(f"decoder_scan_train: the C {kind} layout "
                                 f"of B={B} L={L} M={M} D={D} S={S}, {n} "
                                 f"clusters of {C}, resident rows {res}, "
                                 f"content {content}, {nf} filters has "
                                 f"{got} bytes, the mirror {want}")
                        checked += 1
    log(f"phase 12 decoder_train layout: C equals the mirror in {checked} "
        f"plans (the conv branch with 1 and 10 filters, the content "
        f"branch)")
    plans = {}
    for kind in dt.KINDS:
        active = dt.max_active_clusters(kind, dev)
        for B in (32, 64):
            p = dt.launch_plan(kind, B, *dims, dev)
            plans[f"{kind}_B{B}"] = p
            log(f"phase 12 decoder_scan_train {kind} plan B={B}: "
                f"{p['clusters']} clusters of {p['cluster']} blocks = "
                f"{p['blocks']} blocks, {p['rows']} rows a cluster at most, "
                f"rows with tiles in shared memory "
                f"{ {k: p[f'res_{k}'] for k in dt.TILES[kind]} }, "
                f"{p['smem_bytes']} bytes a block; the card holds at once "
                f"{active}")
    return plans


def decoder_train_phase(t, dev, results):
    """Phase 12: decoder_scan_train's forward and backward kernels vs the
    plain version at the flagship decoder's shapes (T=100 labels, B=32,
    L=200 frames, M=250, D=500, S=250, 201 taps), both priors, ragged
    label and frame masks: the outputs and every gradient; then the
    launch plans, and the kernels' times alone and through autograd at
    B=32 and B=64."""
    from attention_lvcsr_torch.ops import decoder_train as dt
    rng = np.random.RandomState(12)
    ops, fixed, cots = decoder_operands(t, dev, rng)
    names = list(ops)
    T, B, S = ops["fx"].shape
    L, M, D = ops["pre"].shape[1], ops["pre"].shape[2], \
        ops["attended"].shape[2]
    plans = decoder_plans(dev, (L, M, D, S))
    priors = {"expanding": {"type": "expanding", "initial_begin": 0,
                            "initial_end": 40, "min_speed": 1.2,
                            "max_speed": 2.2},
              "window_around_median": {"type": "window_around_median",
                                       "before": 100, "after": 100}}

    def scan(fn, prior, fixed):
        def call(*xs):
            d = dict(zip(names, xs))
            return fn(d["fx"], d["fg"], fixed["mask"], d["pre"],
                      d["attended"], fixed["att_mask"], d["h0"], fixed["w0"],
                      d["wa0"], d["toep"], d["st"], d["hand"], d["v"],
                      d["wss"], d["wsg"], d["dxm"], d["dgm"], prior=prior)
        return call

    leaves = [ops[n] for n in names]
    worst, abs_err = 0.0, 0.0
    for pname, prior in priors.items():
        got, ggot = grads_of(scan(dt.decoder_scan_train, prior, fixed),
                             leaves, cots)
        ref, gref = grads_of(scan(dt.decoder_scan_train_reference, prior,
                                  fixed), leaves, cots)
        outs = ("h", "weights", "wa", "energies")
        errs = relative_errors(
            dict(zip(outs, got), **{f"d{n}": g for n, g in zip(names, ggot)}),
            dict(zip(outs, ref), **{f"d{n}": g for n, g in zip(names, gref)}))
        log(f"phase 12 decoder_scan_train {pname}: max abs err over max abs "
            f"value: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        # f32 in another summation order through 100 dependent steps; the
        # parameter gradients also sum over B*T rows (1e-4 of their scale)
        if not max(errs.values()) <= 1e-4:
            fail(f"decoder_scan_train disagrees with its plain version "
                 f"({pname})")
        repeat(f"decoder_scan_train ({pname})", ggot,
               grads_of(scan(dt.decoder_scan_train, prior, fixed), leaves,
                        cots))
        worst = max(worst, *errs.values())
        abs_err = max(abs_err, *[float((a - b).abs().max()) for a, b in
                                 zip(list(got) + list(ggot),
                                     list(ref) + list(gref))])
    prior = priors["window_around_median"]
    fwd = scan(dt.decoder_scan_train, prior, fixed)
    plain = scan(dt.decoder_scan_train_reference, prior, fixed)
    fwd_ms = cuda_ms(lambda: fwd(*leaves), 3)
    bwd_ms = backward_ms(fwd, leaves, cots, 3)
    plain_fwd = cuda_ms(lambda: plain(*leaves), 1)
    plain_bwd = backward_ms(plain, leaves, cots, 1)
    alone = {}
    with timed_launches(dt, 5, alone):
        grads_of(fwd, leaves, cots)
    # one step of one row: the attention step with its Toeplitz band
    # (2L^2), the distribute products (2 * D * 3S) and the GRU step; the
    # backward recomputes the attention step and does twice the products
    row_ops = attention_step_ops(S, M, L, L, D) + 2 * D * 3 * S \
        + gru_step_ops(S)
    n_ops = T * B * row_ops
    fwd_bytes = nbytes(*leaves, *fixed.values()) + nbytes(*got) \
        + 3 * nbytes(got[0])
    bwd_bytes = nbytes(*leaves, *fixed.values(), *cots, *got) \
        + 3 * nbytes(got[0]) + nbytes(*gref)
    result = results["decoder_scan_train"] = {
        "max_abs_err": abs_err, "max_rel_err": worst,
        "ms": fwd_ms + bwd_ms, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
        "fwd_kernel_ms": alone["decoder_train_fwd_f32"],
        "bwd_kernel_ms": alone["decoder_train_bwd_f32"],
        "plain_ms": plain_fwd + plain_bwd, "plain_fwd_ms": plain_fwd,
        "plain_bwd_ms": plain_bwd,
        **bound(fwd_bytes + bwd_bytes, 4 * n_ops),
        "fwd_bound_ms": bound(fwd_bytes, n_ops)["bound_ms"],
        "bwd_bound_ms": bound(bwd_bytes, 3 * n_ops)["bound_ms"],
        "library_ms": None,
        **{f"{k}_blocks": p["blocks"] for k, p in plans.items()}}
    log(f"  B={B}: forward {fwd_ms:.3f} ms (kernel alone "
        f"{result['fwd_kernel_ms']:.3f}), autograd backward {bwd_ms:.3f} "
        f"ms (kernel alone {result['bwd_kernel_ms']:.3f}); plain: forward "
        f"{plain_fwd:.3f} ms, backward {plain_bwd:.3f} ms; bound "
        f"{result['bound_ms']:.3f} ms (forward {result['fwd_bound_ms']:.3f}, "
        f"backward {result['bwd_bound_ms']:.3f}; median prior)")
    # B=64: the kernels alone and through autograd, on the kernel route
    ops64, fixed64, cots64 = decoder_operands(t, dev, rng, B=64)
    leaves64 = [ops64[n] for n in names]
    fwd64 = scan(dt.decoder_scan_train, prior, fixed64)
    alone = {}
    with timed_launches(dt, 5, alone):
        grads_of(fwd64, leaves64, cots64)
    result.update(
        B64_fwd_ms=cuda_ms(lambda: fwd64(*leaves64), 3),
        B64_bwd_ms=backward_ms(fwd64, leaves64, cots64, 3),
        B64_fwd_kernel_ms=alone["decoder_train_fwd_f32"],
        B64_bwd_kernel_ms=alone["decoder_train_bwd_f32"])
    log(f"  B=64: forward {result['B64_fwd_ms']:.3f} ms (kernel alone "
        f"{result['B64_fwd_kernel_ms']:.3f}), autograd backward "
        f"{result['B64_bwd_ms']:.3f} ms (kernel alone "
        f"{result['B64_bwd_kernel_ms']:.3f})")


# wsj_paper.yaml's rule chain: clip 100, adadelta 0.95 / 1e-8, max_norm 1.0
TRAIN_CONFIG = {"training": {"gradient_threshold": 100.0,
                             "rules": ["adadelta"], "decay_rate": 0.95,
                             "epsilon": 1e-8},
                "regularization": {"max_norm": 1.0}}
SEARCH_TRAIN_EPSILON = 1e-10     # phase 18's training steps, see there
TRAIN_KERNELS = ("gru_scan_train", "gru_scan_train_bidir",
                 "decoder_scan_train", "lstm_scan_train", "outer_sum")


def train_batches(t, dev, n, B=32, T=800, TL=100, seed=13):
    """``n`` flagship-shaped batches, ragged frames and labels (row 0
    full)."""
    import torch
    from __graft_entry__ import FLAGSHIP_NET
    V = FLAGSHIP_NET["num_phonemes"]
    rng = np.random.RandomState(seed)
    batches = []
    for _ in range(n):
        frames = rng.randint(T * 3 // 4, T + 1, size=B)
        labels = rng.randint(TL * 3 // 4, TL + 1, size=B)
        frames[0], labels[0] = T, TL
        batches.append({
            "recordings": t(rng.randn(B, T, 123)),
            "recordings_mask": t(np.arange(T)[None] < frames[:, None]),
            "labels": torch.tensor(rng.randint(0, V - 1, size=(B, TL)),
                                   device=dev),
            "labels_mask": t(np.arange(TL)[None] < labels[:, None])})
    return batches


def train_counters():
    from attention_lvcsr_torch.ops import decoder_train as dt
    from attention_lvcsr_torch.ops import gru_scan as gs
    from attention_lvcsr_torch.ops import gru_train as gt
    from attention_lvcsr_torch.ops import lstm_scan as ls
    from attention_lvcsr_torch.ops import lstm_train as lt
    from attention_lvcsr_torch.ops import outer_sum as osum
    return {"gru_scan_train": gt.launches,
            "gru_scan_train_bidir": gt.launches_bidir,
            "decoder_scan_train": dt.launches, "lstm_scan_train": lt.launches,
            "outer_sum": osum.launches, "gru_scan": gs.launches,
            "lstm_scan": ls.launches}


def train_steps(dev, net, batches, n, save, valid=None):
    """``n`` steps of ``make_train_step`` through ``run_training`` from the
    seed-1234 parameters, validating on the batches ``valid`` where given:
    (recognizer, loop, launches, monitors)."""
    import torch
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from attention_lvcsr_torch.train.driver import run_training
    from attention_lvcsr_torch.train.rules import build_optimizer
    counters = train_counters()
    rec = SpeechRecognizer(net, init_config=FLAGSHIP_INIT, seed=1234,
                           device=dev)
    opt = build_optimizer(TRAIN_CONFIG["training"],
                          TRAIN_CONFIG["regularization"])
    for c in counters.values():
        c.reset()
    loop = run_training(rec, opt, lambda: batches[:n], save, TRAIN_CONFIG,
                        num_batches=n, printing=False,
                        valid_stream=(lambda: valid) if valid else None)
    torch.cuda.synchronize()
    return rec, loop, counts(counters), {
        k: np.array(loop.log.channel(k)[1]) for k in (
            "train_cost", "total_gradient_norm", "time_train_this_batch",
            "valid_sequence_total_cost")}


def plain_train_steps(dev, net, batches, n, save, valid=None):
    """``train_steps`` with every training scan swapped for its plain
    version; fails if a training kernel launched all the same."""
    from attention_lvcsr_torch.models import cells as cells_mod
    from attention_lvcsr_torch.models import generator as generator_mod
    from attention_lvcsr_torch.ops import decoder_train as dt
    from attention_lvcsr_torch.ops import gru_train as gt
    from attention_lvcsr_torch.ops import lstm_train as lt
    with swapped([(cells_mod, "gru_scan_train", gt.gru_scan_train_reference),
                  (cells_mod, "lstm_scan_train",
                   lt.lstm_scan_train_reference),
                  (generator_mod, "decoder_scan_train",
                   dt.decoder_scan_train_reference)]):
        _, _, moved, ref = train_steps(dev, net, batches, n, save, valid)
    if any(moved[k] for k in TRAIN_KERNELS):
        fail(f"the plain route launched kernels: {moved}")
    return ref


def steps_agree(phase, name, got, ref):
    """Per step of the plain route: train_cost and total_gradient_norm
    within 1e-4 relative (f32 in another summation order through the
    encoder's 800-step scans and the decoder's 100, carried over the
    steps)."""
    for key in ("train_cost", "total_gradient_norm"):
        g = got[key][:len(ref[key])]
        rel = np.abs(g - ref[key]) / np.abs(ref[key])
        log(f"phase {phase} {name}: {key} per step {got[key].tolist()} vs "
            f"plain {ref[key].tolist()} (max rel err {rel.max():.2e})")
        if not (np.isfinite(got[key]).all() and rel.max() <= 1e-4):
            fail(f"{name}: {key} disagrees with the plain route")


def valid_agree(got, ref, loop):
    """Phase 13's validation passes (before the first step and after the
    fifth): the kernel route's valid_sequence_total_cost within 1e-4
    relative of the plain route's, and the _best_ll copy written."""
    key = "valid_sequence_total_cost"
    g, r = got[key], ref[key]
    rel = np.abs(g - r) / np.abs(r)
    log(f"phase 13 validation on 2 batches at iterations "
        f"{loop.log.channel(key)[0]}: {key} {g.tolist()} vs plain "
        f"{r.tolist()} (max rel err {rel.max() if len(r) else 0.0:.2e}); "
        f"saved to {[os.path.basename(p) for p in loop.log.channel('saved_to')[1]]}")
    if not (len(g) == len(r) == 2 and np.isfinite(g).all()
            and rel.max() <= 1e-4):
        fail(f"the validation cost disagrees with the plain route: {g} vs "
             f"{r}")


def repeats(name, got, again):
    if any(not np.array_equal(again[k], got[k])
           for k in ("train_cost", "total_gradient_norm")):
        fail(f"{name}: a second run of the kernel route gave other monitors")


def train_step_phase(t, dev, launches, rates):
    """Phase 13: the flagship training step, five steps of
    ``make_train_step`` through ``run_training`` with wsj_paper.yaml's rule
    chain, B=32, 800 frames, 100 labels, ragged: on the kernel route and
    on the plain route from the same parameters and batches; then two
    steps of the same model with a one-directional encoder (the path of
    the one-direction kernel)."""
    from __graft_entry__ import FLAGSHIP_NET
    from attention_lvcsr_torch.train.checkpoint import load_checkpoint
    B = 32
    batches = train_batches(t, dev, 5)
    valid = train_batches(t, dev, 2, seed=14)
    with tempfile.TemporaryDirectory() as tmp:
        save = os.path.join(tmp, "flagship.zip")
        rec, loop, moved, got = train_steps(dev, dict(FLAGSHIP_NET), batches,
                                            5, save, valid)
        log(f"phase 13 launches in 5 flagship training steps: {moved}")
        if min(moved["gru_scan_train_bidir"], moved["decoder_scan_train"],
               moved["outer_sum"]) < 1 or moved["gru_scan"]:
            fail(f"the training step did not run through its kernels: "
                 f"{moved}")
        launches.update(gru_scan_train_bidir=moved["gru_scan_train_bidir"],
                        decoder_scan_train=moved["decoder_scan_train"],
                        outer_sum=moved["outer_sum"])
        state = load_checkpoint(save)
        same = all(np.array_equal(state["parameters"][k], v)
                   for k, v in rec.param_path_dict().items()) \
            and set(state["parameters"]) == set(rec.param_path_dict())
        saved = loop.algorithm.opt_state_arrays()
        same_opt = state["opt_state"] is not None and set(
            state["opt_state"]) == set(saved) and all(
            np.array_equal(state["opt_state"][k], v)
            for k, v in saved.items())
        if not (same and same_opt and state["meta"]["iterations_done"] == 5):
            fail("the checkpoint does not read back as it was trained")
        ref = plain_train_steps(dev, dict(FLAGSHIP_NET), batches, 5,
                                os.path.join(tmp, "plain.zip"), valid)
        steps_agree(13, "flagship", got, ref)
        valid_agree(got, ref, loop)
        repeats("flagship", got, train_steps(
            dev, dict(FLAGSHIP_NET), batches, 5,
            os.path.join(tmp, "again.zip"))[3])
        rates["train_step_utt_per_s"] = B / float(
            np.median(got["time_train_this_batch"]))
        rates["plain_train_step_utt_per_s"] = B / float(
            np.median(ref["time_train_this_batch"]))
        log(f"phase 13 flagship training step B={B} frames=800 labels=100: "
            f"kernel route {rates['train_step_utt_per_s']:.2f} utt/s (median "
            f"of 5 steps, "
            f"{[round(float(x), 4) for x in got['time_train_this_batch']]} s), "
            f"plain route {rates['plain_train_step_utt_per_s']:.2f} utt/s; "
            f"the checkpoint reads back identical (parameters and "
            f"optimizer state); a second kernel run repeats the per-step "
            f"train_cost and total_gradient_norm bit for bit")

        uni = dict(FLAGSHIP_NET, bidir=False)
        _, _, moved, got = train_steps(dev, uni, batches, 2,
                                       os.path.join(tmp, "uni.zip"))
        log(f"phase 13 launches in 2 one-directional training steps: "
            f"{moved}")
        if moved["gru_scan_train"] < 1 or moved["decoder_scan_train"] < 1:
            fail(f"the one-directional step did not run through its "
                 f"kernels: {moved}")
        launches["gru_scan_train"] = moved["gru_scan_train"]
        ref = plain_train_steps(dev, uni, batches, 2,
                                os.path.join(tmp, "uni_plain.zip"))
        steps_agree(13, "one-directional encoder", got, ref)
        rates["uni_train_step_utt_per_s"] = B / float(
            np.median(got["time_train_this_batch"]))


def speech_like(rng, n, sample_rate):
    """Harmonic tones on a slow envelope plus noise: every mel bin well
    above the log floor, as in speech."""
    tt = np.arange(n) / sample_rate
    f0 = rng.uniform(90, 250)
    wav = sum(rng.uniform(0.05, 0.3) / k * np.sin(2 * np.pi * k * f0 * tt
                                                    + rng.uniform(0, 6.3))
              for k in range(1, 12))
    wav = wav * (0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(2, 5) * tt))
    return (wav + rng.uniform(0.01, 0.05) * rng.randn(n)).astype(np.float32)


def frontend_ops(rate, frames, num_bins=40, order=2):
    """Float32 operations of ``frames`` frames of the frontend as
    ``csrc/frontend.cu`` computes them: preemphasis and window (3 a
    sample of the frame), the N = n / 2 point complex FFT (5 N log2 N),
    the real split and power (17 a bin), the mel sums (2 a nonzero
    weight), the energy (2 a sample), the log of each base feature and
    the delta passes (7 a value and pass); and, for comparison, the DFT
    products the TPU kernel's design computes instead (2 products of
    frame_length x n_freqs MACs and the dense mel product)."""
    from attention_lvcsr_torch.ops import frontend as fe
    frame_length = fe.frame_geometry(rate)[0]
    n, _, _, N = fe.fft_geometry(rate)
    nnz = int(np.count_nonzero(fe.mel_schedule(rate, num_bins)["w"]))
    d0 = num_bins + 1
    fft = (3 * frame_length + 5 * N * int(np.log2(N)) + 17 * (N + 1)
           + 2 * nnz + 2 * frame_length + d0 + 7 * d0 * order)
    dft = 2 * frame_length * (N + 1) * 2 + (N + 1) * num_bins * 2
    return frames * fft, frames * dft


def frontend_phase(t, dev, results):
    """Phase 14: fbank_deltas kernel vs its plain version at B=64, 8 s of
    16 kHz audio with ragged true frame counts, then at B=1 with 8 s at
    16, 8, 22.05, 44.1 and 48 kHz (one serving request, the shape phase
    15 launches it at): the launch plan, the C layout against its mirror,
    the error in the log domain.  At 16 kHz, B=1 and B=64, the times of
    the kernel and of the plain version as CUDA graphs of launches, the
    bound from the operations of the FFT route (the DFT route's count
    logged beside it), and torch.fft.rfft on the same windowed frames
    (informational).  The kernels line gets the B=1 times, the B=64 ones
    beside them."""
    import ctypes
    import torch
    from attention_lvcsr_torch import _build
    from attention_lvcsr_torch.ops import frontend as fe
    lib = _build.load().lib
    lib.frontend_smem_bytes.argtypes = [ctypes.POINTER(fe._Args)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.RandomState(14)
    worst, timed = 0.0, {}
    for B, rate in ((64, 16000), (1, 16000), (1, 8000), (1, 22050),
                    (1, 44100), (1, 48000)):
        N = 8 * rate
        frame_length, hop, fft_size = fe.frame_geometry(rate)
        lengths = rng.randint(2 * rate, N + 1, size=B)
        lengths[0] = N
        wav_np = np.zeros((B, N), np.float32)
        for b, n in enumerate(lengths):
            wav_np[b, :n] = speech_like(rng, n, rate)
        wav = t(wav_np)
        counts = torch.tensor(1 + (lengths - frame_length) // hop,
                              device=dev)
        got = fe.fbank_deltas(wav, counts, sample_rate=rate)
        ref = fe.fbank_deltas_plain(wav, counts, sample_rate=rate)
        torch.cuda.synchronize()
        T = got.shape[1]
        valid = torch.arange(T, device=dev)[None] < counts[:, None]
        err = float((got - ref).abs()[valid].max())
        worst = max(worst, err)
        plan = fe.plan(B, T, rate, sms=sms)
        host = fe.host_tables(rate, 40)
        c_bytes = lib.frontend_smem_bytes(ctypes.byref(fe._Args(
            B=B, N=N, T=T, frame_length=frame_length, hop=hop,
            log2n=fe.fft_geometry(rate)[1], num_bins=40,
            mel_emits=host["emits"], mel_slots=host["slots"], use_energy=1,
            order=2, rows=plan["rows"])))
        log(f"phase 14 fbank_deltas B={B} {rate} Hz, {N} samples, T={T}, "
            f"{int(counts.sum())} valid frames: max abs err {err:.3e} over "
            f"the valid rows (log domain); plan {plan}, C layout {c_bytes} "
            f"bytes")
        if not (err <= 1e-3 and torch.isfinite(got).all()):
            fail(f"fbank_deltas disagrees with its plain version: {err}")
        if c_bytes != plan["smem_bytes"]:
            fail(f"fbank_deltas: the C layout has {c_bytes} bytes, the "
                 f"mirror {plan['smem_bytes']}")
        if B == 1 and plan["blocks"] < min(sms, T):
            fail(f"fbank_deltas: one request got {plan['blocks']} blocks "
                 f"on {sms} SMs")
        if rate != 16000:
            continue
        ops, dft_ops = frontend_ops(rate, int(counts.sum()))
        tables, ints = fe._tables(rate, 40, dev)
        timed[B] = {
            "ms": graph_ms(lambda: fe.fbank_deltas(wav, counts), 50),
            "plain_ms": graph_ms(lambda: fe.fbank_deltas_plain(wav, counts),
                                 5),
            **bound(nbytes(wav, counts, tables, ints, got), ops)}
        # torch.fft.rfft of the same preemphasised, windowed frames
        frames = wav.unfold(1, frame_length, hop)
        pre = frames - fe.PREEMPHASIS * torch.cat(
            [frames[..., :1], frames[..., :-1]], dim=-1)
        windowed = pre * torch.hamming_window(
            frame_length, periodic=False, device=dev)
        rfft_ms = cuda_ms(lambda: torch.fft.rfft(windowed, n=fft_size), 20)
        log(f"  B={B}, 16 kHz: kernel {timed[B]['ms']:.4f} ms, plain "
            f"{timed[B]['plain_ms']:.4f} ms (CUDA graphs), bound "
            f"{timed[B]['bound_ms']:.4f} ms ({timed[B]['bound_by']}; "
            f"{ops} operations of the FFT route, which the bound counts, "
            f"against {dft_ops} of the DFT products); torch.fft.rfft of "
            f"the windowed frames alone {rfft_ms:.4f} ms (informational)")
    results["fbank_deltas"] = dict(
        timed[1], max_abs_err=worst, library_ms=None,
        **{f"b64_{k}": v for k, v in timed[64].items()})


def waveform_serve_phase(dev, rec, launches):
    """Phase 15: 8 concurrent waveform requests to the flagship server at
    max_batch 1: each answer equals the answer to a features request
    carrying the frontend kernel's own output for the same waveform.  The
    EOS logit is raised by 1.5 for the phase, so that hypotheses finish."""
    import torch
    from attention_lvcsr_torch.ops import frontend as fe
    from attention_lvcsr_torch.serve import Transcriber, make_server
    post_b = rec.net.generator.readout.post_merge_0.bias
    with torch.no_grad():              # in place: the loop's tables follow
        post_b[rec.eos_label] += 1.5
    server = make_server(Transcriber(rec, char_map=CHAR_MAP, beam_size=10),
                         "127.0.0.1", 0, max_batch=1, batch_wait_ms=5.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address

    def post(payload, npy=False):
        if npy:
            buf = io.BytesIO()
            np.save(buf, payload)
            data, ctype = buf.getvalue(), "application/octet-stream"
        else:
            data, ctype = json.dumps(payload).encode(), "application/json"
        req = urllib.request.Request(f"http://{host}:{port}/decode",
                                     data=data,
                                     headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=300) as resp:
            return json.loads(resp.read())

    try:
        rng = np.random.RandomState(15)
        rates = [16000] * 7 + [8000]
        waves = [speech_like(rng, int(rng.uniform(2, 8) * r), r)
                 for r in rates]
        answers, errors = {}, []

        def client(i):
            try:
                answers[i] = post({"waveform": waves[i].tolist(),
                                   "sample_rate": rates[i]})
            except Exception as exc:     # reported below
                errors.append(f"request {i}: {exc}")

        fe.launches.reset()
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
        wall = time.perf_counter() - t0
        moved = fe.launches.count
        if errors or len(answers) != 8:
            fail(f"phase 15: {errors or 'missing answers'}")
        if moved != 8:
            fail(f"phase 15: the frontend launched {moved} times for 8 "
                 f"waveform requests")
        launches["fbank_deltas"] = moved
        finished = 0
        for i, (wav, rate) in enumerate(zip(waves, rates)):
            feats = fe.fbank_deltas(torch.tensor(wav, device=dev)[None],
                                    sample_rate=rate)[0].cpu().numpy()
            direct = post(feats, npy=True)
            if answers[i] != direct:
                fail(f"phase 15: waveform request {i} answered "
                     f"{answers[i]} but its features give {direct}")
            finished += direct["cost"] is not None
        if finished < 1:
            fail("phase 15: no waveform request finished a hypothesis: the "
                 "comparison is too weak")
        try:
            post({"waveform": [0.1] * 399, "sample_rate": 16000})
            fail("phase 15: a too-short waveform was decoded")
        except urllib.error.HTTPError as exc:
            if exc.code != 400:
                fail(f"phase 15: a too-short waveform got {exc.code}")
        log(f"phase 15 8 concurrent waveform requests "
            f"({[round(len(w) / r, 2) for w, r in zip(waves, rates)]} s, "
            f"one at 8 kHz) answered in {wall:.3f} s, each equal to the "
            f"features request of the kernel's own features ({finished} "
            f"with a finished hypothesis); fbank_deltas launches {moved}; a "
            f"too-short waveform gets 400")
    finally:
        server.batcher.close()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        with torch.no_grad():
            post_b[rec.eos_label] -= 1.5


def lstm_step_ops(D):
    """Operations of one LSTM step of one row: the recurrent product
    (2 * D * 4D) and about twenty elementwise ones per unit."""
    return 8 * D * D + 20 * D


def lstm_phase(t, dev, results):
    """Phase 16: lstm_scan at T=800, B=64, D=250 (both directions, and one
    alone), and lstm_scan_train's forward and backward kernels at T=800,
    B=32, both directions, vs their plain versions."""
    import torch
    from attention_lvcsr_torch.ops import lstm_scan as ls
    from attention_lvcsr_torch.ops import lstm_train as lt
    rng = np.random.RandomState(16)
    D = 250

    def operands(T, B, ndir):
        lengths = rng.randint(300, T + 1, size=B)
        lengths[0] = T
        mask = t((np.arange(T)[:, None] < lengths[None]).astype(np.float32))
        dirs = [(t(rng.randn(B, D) * 0.1), t(rng.randn(B, D) * 0.1),
                 t(rng.randn(D, 4 * D) / np.sqrt(D)), t(rng.randn(D) * 0.1),
                 t(rng.randn(D) * 0.1), t(rng.randn(D) * 0.1))
                for _ in range(ndir)]
        return t(rng.randn(T, B, 4 * D * ndir) * 0.5), mask, dirs

    plans = lstm_plans(dev, D)
    T, B = 800, 64
    proj, mask, dirs = operands(T, B, 2)
    got = ls.lstm_scan(proj, mask, *dirs)
    ref = ls.lstm_scan_reference(proj, mask, *dirs)
    one = ls.lstm_scan(proj[..., :4 * D].contiguous(), mask, dirs[0])
    again = ls.lstm_scan(proj, mask, *dirs)
    torch.cuda.synchronize()
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    err_one = max(float((g - r[..., :D]).abs().max())
                  for g, r in zip(one, ref))
    log(f"phase 16 lstm_scan T={T} B={B} D={D}, both directions: states "
        f"and cells max abs err {err:.3e} (one direction alone: "
        f"{err_one:.3e})")
    if not max(err, err_one) <= 1e-5:
        fail(f"lstm_scan disagrees with its plain version: {err}, {err_one}")
    if not all(torch.equal(g, h) for g, h in zip(got, again)):
        fail("lstm_scan: a second call gave other states")
    weights = [w for d in dirs for w in d]
    results["lstm_scan"] = {
        "max_abs_err": max(err, err_one), **plans,
        "ms": cuda_ms(lambda: ls.lstm_scan(proj, mask, *dirs), 5),
        "plain_ms": cuda_ms(lambda: ls.lstm_scan_reference(proj, mask,
                                                           *dirs), 2),
        **bound(nbytes(proj, mask, *weights, *got),
                2 * T * B * lstm_step_ops(D)),
        "library_ms": None}
    log(f"  kernel {results['lstm_scan']['ms']:.3f} ms, plain "
        f"{results['lstm_scan']['plain_ms']:.3f} ms, bound "
        f"{results['lstm_scan']['bound_ms']:.3f} ms")

    B, max_err = 32, 0.0
    for ndir in (1, 2):    # the timings below take the last: both
        proj, mask, dirs = operands(T, B, ndir)
        cots = [t(rng.randn(T, B, D * ndir))]
        leaves = [proj] + [w for d in dirs for w in d]

        def scan(fn):
            return lambda p, *w: fn(p, mask, tuple(w[:6]),
                                    tuple(w[6:]) if ndir == 2 else None)

        (got, cells), ggot = grads_of(scan(lt.lstm_scan_train), leaves,
                                      cots)
        (ref, ref_cells), gref = grads_of(
            scan(lt.lstm_scan_train_reference), leaves, cots)
        names = ["dx"] + [f"{n}[{i}]" for i in range(ndir) for n in (
            "dh0", "dc0", "dW_state", "dpci", "dpcf", "dpco")]
        errs = relative_errors(dict(zip(names, ggot)),
                               dict(zip(names, gref)))
        state_err = max(float((got - ref).abs().max()),
                        float((cells - ref_cells).abs().max()))
        log(f"phase 16 lstm_scan_train T={T} B={B} D={D}, "
            f"{'both directions' if ndir == 2 else 'one direction'}: "
            f"states and cells max abs err {state_err:.3e}; gradients, max "
            f"abs err over max abs value: "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        # states: f32 in another summation order, 1e-5 absolute;
        # gradients: sums over the reverse recurrence and, for the
        # weights, over T*B = 25600 rows in another order (1e-4 of their
        # scale)
        if not (state_err <= 1e-5 and max(errs.values()) <= 1e-4):
            fail("lstm_scan_train disagrees with its plain version")
        repeat("lstm_scan_train", ggot, grads_of(scan(lt.lstm_scan_train),
                                                 leaves, cots))
        max_err = max(max_err, state_err, *[
            float((a - b).abs().max()) for a, b in zip(ggot, gref)])
    fwd, plain = scan(lt.lstm_scan_train), scan(lt.lstm_scan_train_reference)
    fwd_ms = cuda_ms(lambda: fwd(*leaves), 3)
    bwd_ms = backward_ms(fwd, leaves, cots, 3)
    plain_fwd = cuda_ms(lambda: plain(*leaves), 1)
    plain_bwd = backward_ms(plain, leaves, cots, 1)
    kernel_ms = lstm_backward_kernel_ms(proj, mask, dirs, cots[0], 3)
    # forward: projections, mask, weights in; states, cells and the four
    # gates out.  Backward: cotangent, cells, the four gates, states (the
    # weight gradient's left factor), mask and weights in; the
    # projections' and weights' gradients out; twice the forward's
    # products (state gradient, weight gradient)
    weights = leaves[1:]
    fwd_bytes = nbytes(proj, mask, *weights) + 2 * nbytes(got) \
        + 4 * nbytes(got)
    bwd_bytes = nbytes(*cots) + 6 * nbytes(got) + nbytes(mask, *weights) \
        + nbytes(proj, *weights)
    ops = 2 * T * B * lstm_step_ops(D)
    results["lstm_scan_train"] = {
        "max_abs_err": max_err,
        "ms": fwd_ms + bwd_ms, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
        "bwd_kernel_ms": kernel_ms,
        "bwd_kernel_us_per_step": kernel_ms * 1e3 / T,
        "plain_ms": plain_fwd + plain_bwd, "plain_fwd_ms": plain_fwd,
        "plain_bwd_ms": plain_bwd,
        **bound(fwd_bytes + bwd_bytes, 3 * ops),
        "fwd_bound_ms": bound(fwd_bytes, ops)["bound_ms"],
        "bwd_bound_ms": bound(bwd_bytes, 2 * ops)["bound_ms"],
        "library_ms": None}
    log(f"  kernels: forward {fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms "
        f"(of which lstm_train.cu's kernel {kernel_ms:.3f} ms, "
        f"{kernel_ms * 1e3 / T:.2f} us a step); plain: forward "
        f"{plain_fwd:.3f} ms, backward {plain_bwd:.3f} ms; bound "
        f"{results['lstm_scan_train']['bound_ms']:.3f} ms")


def lstm_plans(dev, D):
    """Phase 16, first: both LSTM kernels' C shared-memory layouts against
    their Python mirrors, and the forward's cluster plan at the training
    forward's B=32 and the decode's B=64 (both directions)."""
    import ctypes
    from attention_lvcsr_torch import _build
    from attention_lvcsr_torch.ops import lstm_scan as ls
    from attention_lvcsr_torch.ops import lstm_train as lt
    lib = _build.load().lib
    lib.lstm_scan_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.lstm_train_smem_bytes.argtypes = [ctypes.c_int]
    for width in (D, 275, 300, 352, 384):
        for size in (16, 8):
            mirror = ls.fwd_layout(width, size)["smem_bytes"]
            if lib.lstm_scan_smem_bytes(width, size) != mirror:
                fail(f"lstm_scan: the C layout at D={width} with {size}-block "
                     f"clusters has {lib.lstm_scan_smem_bytes(width, size)} "
                     f"bytes, the mirror {mirror}")
        mirror = lt.bwd_layout(width)["smem_bytes"]
        if lib.lstm_train_smem_bytes(width) != mirror:
            fail(f"lstm_train: the C layout at D={width} has "
                 f"{lib.lstm_train_smem_bytes(width)} bytes, the mirror "
                 f"{mirror}")
    result = {}
    for B in (32, 64):
        plan = ls.launch_plan(D, B, 2, dev)
        log(f"phase 16 lstm_scan plan B={B} D={D}, both directions: "
            f"{plan['clusters']} clusters of {plan['cluster']} blocks; the "
            f"card holds at once {plan['active'][16]} 16-block and "
            f"{plan['active'][8]} 8-block clusters "
            f"({ls.fwd_layout(D, 16)['smem_bytes']} and "
            f"{ls.fwd_layout(D, 8)['smem_bytes']} bytes a block)")
        result[f"cluster_B{B}"] = plan["cluster"]
    log(f"phase 16 lstm_train.cu: {lt.BWD_CLUSTER}-block clusters, "
        f"{lt.bwd_layout(D)['smem_bytes']} bytes a block; C layouts equal "
        f"the mirrors at D={D}, 275, 300, 352, 384")
    return result


def lstm_backward_kernel_ms(proj, mask, dirs, cot, repeats):
    """Device time of lstm_train.cu's backward kernel alone (no outer_sum,
    no copies), on the forward kernel's cells and gate residuals."""
    import torch
    from attention_lvcsr_torch import _build
    from attention_lvcsr_torch.ops import lstm_scan as ls
    from attention_lvcsr_torch.ops import lstm_train as lt
    T, B, _ = proj.shape
    D, ndir = dirs[0][0].shape[1], len(dirs)
    new = lambda *s: torch.empty(*s, device=proj.device)
    states, cells = new(T, B, D * ndir), new(T, B, D * ndir)
    residuals = [tuple(new(T, B, D) for _ in range(4)) for _ in range(ndir)]
    ls.launch(proj, mask, dirs, states, cells, residuals, "lstm_scan_train")
    dproj = new(T, B, 4 * D * ndir)
    grads = [(new(B, D), new(B, D)) for _ in range(ndir)]
    dpeep = [new(B, 3 * D) for _ in range(ndir)]
    stream = _build.stream_of(proj)
    return cuda_ms(lambda: lt.launch_backward(
        cot, None, cells, mask, dirs, residuals, dproj, grads, dpeep,
        stream), repeats)


def lstm_model_phase(t, dev, launches, rates):
    """Phase 17: the flagship network with a 4x250 BiLSTM encoder: the
    beam-10 decode through lstm_scan + beam_search_loop and five training
    steps through lstm_scan_train + decoder_scan_train, each against its
    plain route."""
    import torch
    from __graft_entry__ import FLAGSHIP_NET
    from attention_lvcsr_torch.models import cells as cells_mod
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from attention_lvcsr_torch.ops import beam_loop as bl
    from attention_lvcsr_torch.ops import lstm_scan as ls
    from attention_lvcsr_torch.search import beam as beam_mod
    net = dict(FLAGSHIP_NET, enc_transition="LSTM")
    rec = SpeechRecognizer(dict(net, max_decoded_length_scale=8.0),
                           init_config=FLAGSHIP_INIT, seed=1234, device=dev)
    rec.init_beam_search(10)
    Bd, Td = 64, 800
    feats = t(np.random.RandomState(17).randn(Bd, Td, 123))
    fmask = torch.ones(Bd, Td, device=dev)

    def decode():
        out = rec.beam_search(feats, fmask, as_arrays=True)
        torch.cuda.synchronize()
        return out

    ls.launches.reset()
    bl.launches.reset()
    out = decode()
    moved = {"lstm_scan": ls.launches.count,
             "beam_search_loop": bl.launches.count}
    log(f"phase 17 launches in one LSTM-encoder decode: {moved}")
    if min(moved.values()) < 1:
        fail(f"the LSTM decode did not run through its kernels: {moved}")
    launches["lstm_scan"] = moved["lstm_scan"]
    if out["done_out"].shape != (Bd, 10, Td // 8) or not np.isfinite(
            out["done_cost"][out["done_valid"]]).all():
        fail(f"LSTM decode output has the wrong shape "
             f"{out['done_out'].shape} or non-finite costs")
    _, times = timed_decodes(decode, 3)
    rates["lstm_decode_utt_per_s"] = Bd / statistics.median(times)
    with swapped([(cells_mod, "lstm_scan", ls.lstm_scan_reference),
                  (beam_mod, "beam_search_loop",
                   bl.beam_search_loop_reference)]):
        out_plain, ptimes = timed_decodes(decode, 1)
    rates["plain_lstm_decode_utt_per_s"] = Bd / statistics.median(ptimes)
    err = compare_outputs("LSTM decode", out, out_plain)
    log(f"phase 17 LSTM-encoder decode B={Bd} frames={Td} beam=10 steps="
        f"{int(out['steps'])}: kernel path "
        f"{rates['lstm_decode_utt_per_s']:.2f} utt/s (median of 3, "
        f"{[round(x, 4) for x in times]} s), plain path "
        f"{rates['plain_lstm_decode_utt_per_s']:.2f} utt/s; outputs agree "
        f"(max abs cost err {err:.3e})")

    B = 32
    batches = train_batches(t, dev, 5, seed=17)
    with tempfile.TemporaryDirectory() as tmp:
        _, _, moved, got = train_steps(dev, net, batches, 5,
                                       os.path.join(tmp, "lstm.zip"))
        log(f"phase 17 launches in 5 LSTM-encoder training steps: {moved}")
        if min(moved["lstm_scan_train"], moved["decoder_scan_train"],
               moved["outer_sum"]) < 1 or moved["lstm_scan"]:
            fail(f"the LSTM training step did not run through its kernels: "
                 f"{moved}")
        launches["lstm_scan_train"] = moved["lstm_scan_train"]
        ref = plain_train_steps(dev, net, batches, 2,
                                os.path.join(tmp, "lstm_plain.zip"))
        steps_agree(17, "LSTM encoder", got, ref)
        repeats("LSTM encoder", got, train_steps(
            dev, net, batches, 5, os.path.join(tmp, "lstm_again.zip"))[3])
    rates["lstm_train_step_utt_per_s"] = B / float(
        np.median(got["time_train_this_batch"]))
    rates["plain_lstm_train_step_utt_per_s"] = B / float(
        np.median(ref["time_train_this_batch"]))
    log(f"phase 17 LSTM-encoder training step B={B} frames=800 labels=100: "
        f"kernel route {rates['lstm_train_step_utt_per_s']:.2f} utt/s "
        f"(median of 5 steps), plain route "
        f"{rates['plain_lstm_train_step_utt_per_s']:.2f} utt/s (2 steps); a "
        f"second kernel run repeats the monitors bit for bit")


class SmokeData:
    """What the search driver needs of a dataset, over the flagship's
    character map: ``decode`` (ids to characters, EOS and BOS dropped),
    ``pretty_print``, and what ``create_model`` reads of a data manager."""
    eos_label = CHAR_MAP["<eol>"]
    bos_label = CHAR_MAP["<bol>"]
    num_labels = len(CHARS)
    add_bos = 1             # as wsj_paper.yaml: the first EOS is ignored

    @staticmethod
    def num_features(source):
        return 123

    @staticmethod
    def character_map(source):
        return dict(CHAR_MAP)

    def decode(self, labels):
        return [CHARS[int(x)] for x in labels
                if int(x) not in (self.eos_label, self.bos_label)]

    def pretty_print(self, labels, example=None):
        return "".join(" " if c == "<spc>" else c
                       for c in self.decode(labels))


def search_examples(n=16, seed=18):
    """``n`` utterances of 300-800 frames with 20-80 labels from the
    alphabet, BOS before and EOS after them as the data pipeline adds
    them under ``add_bos: 1``."""
    rng = np.random.RandomState(seed)
    examples = []
    for i in range(n):
        frames, labels = rng.randint(300, 801), rng.randint(20, 81)
        examples.append({
            "recordings": rng.randn(frames, 123).astype(np.float32),
            "labels": np.concatenate([
                [CHAR_MAP["<bol>"]],
                rng.randint(0, CHAR_MAP["<bol>"], size=labels),
                [CHAR_MAP["<eol>"]]]).astype(np.int64),
            "uttids": f"utt{i:02d}"})
    return examples


def parse_report(text):
    """Per utterance of a search report: {line label: value}."""
    utts = []
    for line in text.splitlines():
        label, _, value = line.partition(":")
        if line.startswith("Utterance "):
            utts.append({"Utterance": line})
        elif utts:
            utts[-1][label] = value.strip()
    return utts


def reports_agree(name, got, ref, numbers, stats=None, ref_stats=None):
    """The kernel route's search report against the plain route's on the
    utterances ``numbers`` (the plain route may have decoded only those):
    the same hypotheses (at most one near tie, beam search costs within
    1e-3 relative), groundtruth and recognized costs within 1e-4
    relative, and the same CER where the hypotheses are equal.  Where both
    routes decoded the same utterances, ``stats`` and ``ref_stats`` are
    their totals, equal where the hypotheses are (total_nll within 1e-4
    relative).  Returns the max relative cost error."""
    g, r = ({int(u["Utterance"].split()[1]): u for u in parse_report(text)}
            for text in (got, ref))
    if not set(numbers) <= set(g) & set(r):
        fail(f"{name}: utterances {sorted(g)} and {sorted(r)} in the "
             f"reports, expected {numbers} in both")
    differ, err = [], 0.0
    for u in numbers:
        a, b = g[u], r[u]
        costs = [("Groundtruth cost", True)]
        if a.get("Recognized") != b.get("Recognized"):
            ca, cb = (float(x["Beam search cost"]) for x in (a, b))
            if abs(ca - cb) > 1e-3 * max(abs(cb), 1.0):
                fail(f"{name}: utterance {u} recognized "
                     f"{a.get('Recognized')!r} ({ca}) but the plain route "
                     f"{b.get('Recognized')!r} ({cb})")
            differ.append(u)
            log(f"{name}: near tie at utterance {u}: {ca} vs {cb}")
        else:
            costs.append(("Recognized cost", "Recognized cost" in b))
            if a["CER"] != b["CER"]:
                fail(f"{name}: utterance {u} CER {a['CER']} vs plain "
                     f"{b['CER']}")
        for key, present in costs:
            if not present:
                continue
            x, y = float(a[key]), float(b[key])
            rel = abs(x - y) / max(abs(y), 1e-30)
            err = max(err, rel)
            if not (np.isfinite(x) and rel <= 1e-4):
                fail(f"{name}: utterance {u} {key} {x} vs plain {y}")
    if len(differ) > 1:
        fail(f"{name}: {len(differ)} utterances differ: {differ}")
    if stats is None:
        return err
    for key in ("num_examples", "total_length"):
        if stats[key] != ref_stats[key]:
            fail(f"{name}: {key} {stats[key]} vs plain {ref_stats[key]}")
    if not differ and stats["total_errors"] != ref_stats["total_errors"]:
        fail(f"{name}: total_errors {stats['total_errors']} vs plain "
             f"{ref_stats['total_errors']}")
    nll_rel = abs(stats["total_nll"] - ref_stats["total_nll"]) / abs(
        ref_stats["total_nll"])
    if nll_rel > 1e-4:
        fail(f"{name}: total_nll {stats['total_nll']} vs plain "
             f"{ref_stats['total_nll']}")
    return err


def search_phase(t, dev, launches, rates):
    """Phase 18: the search driver (``run_search``) and sampling on the
    flagship network, each on the kernel route and the plain route; then
    ``run_training`` with ``monitoring.search``."""
    import torch
    from __graft_entry__ import FLAGSHIP_NET
    from attention_lvcsr_torch.models import attention as attention_mod
    from attention_lvcsr_torch.models import cells as cells_mod
    from attention_lvcsr_torch.models import generator as generator_mod
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from attention_lvcsr_torch.ops import attention_energy as ae
    from attention_lvcsr_torch.ops import beam_loop as bl
    from attention_lvcsr_torch.ops import decoder_train as dt
    from attention_lvcsr_torch.ops import gru_scan as gs
    from attention_lvcsr_torch.ops import gru_train as gt
    from attention_lvcsr_torch.search import beam as beam_mod
    from attention_lvcsr_torch.train.checkpoint import save_checkpoint
    from attention_lvcsr_torch.train.driver import (create_model,
                                                    run_search,
                                                    run_training)
    from attention_lvcsr_torch.train.rules import build_optimizer

    counters = {"gru_scan": gs.launches, "beam_search_loop": bl.launches,
                "beam_attention_energies": ae.launches,
                "gru_scan_train_bidir": gt.launches_bidir,
                "decoder_scan_train": dt.launches}
    plain = [(cells_mod, "gru_scan", gs.gru_scan_reference),
             (beam_mod, "beam_search_loop", bl.beam_search_loop_reference),
             (attention_mod, "beam_attention_energies",
              ae.beam_attention_energies_reference),
             (cells_mod, "gru_scan_train", gt.gru_scan_train_reference),
             (generator_mod, "decoder_scan_train",
              dt.decoder_scan_train_reference)]
    net = {k: v for k, v in FLAGSHIP_NET.items()
           if k not in ("input_dims", "input_num_chars", "eos_label",
                        "num_phonemes")}
    data = SmokeData()
    tmp = tempfile.mkdtemp()
    try:
        ckpt = os.path.join(tmp, "flagship.zip")
        rec = SpeechRecognizer(FLAGSHIP_NET, init_config=FLAGSHIP_INIT,
                               seed=1234, device=dev)
        rec.net.generator.readout.post_merge_0.bias.data[
            rec.eos_label] += 1.5
        save_checkpoint(ckpt, rec.param_path_dict())
        lm_path = os.path.join(tmp, "lm_trigram.npz")
        bench_trigram(lm_path)
        models = {
            "no LM": create_model({"net": net}, data, ckpt, device=dev),
            "LM": create_model({"net": dict(net, lm={
                "path": lm_path, "weight": 0.5,
                "no_transition_cost": 20.0})}, data, ckpt, device=dev)}
    finally:
        shutil.rmtree(tmp)
    loaded = models["no LM"].net.generator.readout.post_merge_0.bias
    if not torch.equal(loaded, rec.net.generator.readout.post_merge_0.bias):
        fail("phase 18: the checkpoint did not read back the weights")
    examples = search_examples()

    def drive(rec_, n, conf, decode_only=None):
        """run_search over the first ``n`` examples (those of them in
        ``decode_only``): (report, stats, seconds, launches, seconds in
        analyze, seconds in beam search)."""
        spent = {"analyze": 0.0, "beam_search": 0.0}

        def timed(name):
            fn = getattr(rec_, name)

            def call(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                spent[name] += time.perf_counter() - t0
                return out
            return call

        rec_.analyze, rec_.beam_search = (timed("analyze"),
                                          timed("beam_search"))
        try:
            buf = io.StringIO()
            for c in counters.values():
                c.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = run_search(rec_, [dict(ex) for ex in examples[:n]],
                               data, conf, decode_only=decode_only,
                               print_to=buf)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            del rec_.analyze, rec_.beam_search
        return (buf.getvalue(), stats, wall, counts(counters),
                spent["analyze"], spent["beam_search"])

    # without an LM the random model's best hypothesis is empty (the EOS
    # raised by 1.5 wins) below a character discount of about 3
    no_lm = {"beam_size": 10, "char_discount": 3.0}
    # b's plain route decodes 8 of the 16 in one chunk: the longest and the
    # first 7 others, so the chunk has the same padding and decode cap (a
    # no-LM decode of one utterance does not depend on the others); c's
    # LM decode does (the module path's window spans the chunk), so its
    # plain route decodes all 16
    longest = int(np.argmax([len(ex["recordings"]) for ex in examples]))
    b_plain = sorted({longest, *range(7 if longest >= 7 else 8)})
    runs = [("a", "no LM", 4, dict(no_lm, decode_batch=1),
             ("gru_scan", "beam_search_loop", "gru_scan_train_bidir",
              "decoder_scan_train"), ("beam_attention_energies",), None),
            ("b", "no LM", 16, dict(no_lm, decode_batch=16),
             ("gru_scan", "beam_search_loop", "gru_scan_train_bidir",
              "decoder_scan_train"), ("beam_attention_energies",), b_plain),
            ("c", "LM", 16, {"beam_size": 10, "decode_batch": 16,
                             "char_discount": 1.0},
             ("gru_scan", "beam_attention_energies", "gru_scan_train_bidir",
              "decoder_scan_train"), ("beam_search_loop",), None)]
    search_launches = {}
    for tag, model, n, conf, used, unused, subset in runs:
        name = f"phase 18{tag} search, {model}, decode_batch " \
               f"{conf['decode_batch']}"
        report, stats, wall, moved, t_an, t_bs = drive(models[model], n,
                                                       conf)
        if min(moved[k] for k in used) < 1 or any(moved[k] for k in unused):
            fail(f"{name}: launches {moved}, expected each of {used} and "
                 f"none of {unused}")
        with swapped(plain):
            ref, ref_stats, ref_wall, ref_moved, _, _ = drive(
                models[model], n, conf, decode_only=subset)
        if any(ref_moved.values()):
            fail(f"{name}: the plain route launched kernels: {ref_moved}")
        if subset is None:
            err = reports_agree(name, report, ref, list(range(n)), stats,
                                ref_stats)
        else:
            err = reports_agree(name, report, ref, subset)
        nonempty = sum(bool(u.get("Recognized"))
                       for u in parse_report(report))
        if nonempty < 1:
            fail(f"{name}: no utterance recognized anything: the comparison "
                 f"is too weak")
        n_ref = n if subset is None else len(subset)
        rates[f"search_{tag}_utt_per_s"] = n / wall
        rates[f"plain_search_{tag}_utt_per_s"] = n_ref / ref_wall
        for k in used:
            search_launches[f"{tag}:{k}"] = moved[k]
        log(f"{name}: {n} utterances, {nonempty} non-empty hypotheses, "
            f"average CER {stats['total_errors'] / stats['total_length']:.4f}"
            f", agree with the plain route on "
            f"{'all' if subset is None else subset} (max rel cost err "
            f"{err:.2e}); kernel route {n / wall:.2f} utt/s, plain "
            f"{n_ref / ref_wall:.2f} utt/s ({n_ref} utterances); analyze "
            f"{t_an:.3f} s and beam search {t_bs:.3f} s of {wall:.3f} s "
            f"({100 * t_an / wall:.1f} % and {100 * t_bs / wall:.1f} %); "
            f"launches {moved}")
        if tag == "a":
            rates["search_a_analyze_share"] = t_an / wall
            rates["search_a_beam_search_share"] = t_bs / wall

    # ---- d. sampling ----------------------------------------------------
    rec_s = models["no LM"]

    def sample_all(gen_seed=0):
        outs = []
        for ex in examples[:4]:
            g = torch.Generator(device=dev).manual_seed(gen_seed)
            outs.append(rec_s.sample(ex["recordings"], generator=g))
        torch.cuda.synchronize()
        return outs

    for c in counters.values():
        c.reset()
    samples = sample_all()
    moved = counts(counters)
    if min(moved["gru_scan"], moved["beam_attention_energies"]) < 1 or \
            moved["beam_search_loop"] or moved["decoder_scan_train"]:
        fail(f"phase 18d sample: launches {moved}")
    search_launches["d:gru_scan"] = moved["gru_scan"]
    search_launches["d:beam_attention_energies"] = moved[
        "beam_attention_energies"]
    with swapped(plain):
        ref_samples = sample_all()
    worst = 0.0
    for u, (got, ref, ex) in enumerate(zip(samples, ref_samples,
                                           examples)):
        if not np.array_equal(got["outputs"], ref["outputs"]):
            fail(f"phase 18d: sample {u} drew other symbols on the plain "
                 f"route")
        labels = got["outputs"].T
        ana = rec_s.analyze(ex["recordings"][None],
                            np.ones((1, len(ex["recordings"]))), labels,
                            np.ones(labels.shape))
        for other, what in ((ref["costs"], "the plain route's sample"),
                            (ana["costs"], "its own analyze")):
            rel = float(np.abs(got["costs"] - other).max()
                        / np.abs(other).max())
            worst = max(worst, rel)
            if not (np.isfinite(got["costs"]).all() and rel <= 1e-4):
                fail(f"phase 18d: sample {u}'s per-step costs differ from "
                     f"{what} by {rel:.2e} relative")
    log(f"phase 18d sample: 4 utterances of "
        f"{[s['outputs'].shape[0] for s in samples]} steps at U=1, the same "
        f"draws on the plain route; per-step costs agree with the plain "
        f"route and with each sample's teacher-forced analyze (max rel err "
        f"{worst:.2e}); launches {moved}")

    # ---- run_training with monitoring.search ----------------------------
    # 2 validation batches of 4: under the 10 utterances after which a
    # mean error above 0.8 records the bail-out's 1; 300-400 frames, since
    # the random model's hypotheses run to the decode cap (a third of the
    # frames) and the plain route's search is paced by its steps
    valid = train_batches(t, dev, 2, B=4, T=400, seed=19)
    rec_v = models["no LM"]
    rec_v.init_beam_search(10)
    for batch in valid:
        # the labels the loaded model decodes: its valid_per starts at 0
        out = rec_v.beam_search(batch["recordings"],
                                batch["recordings_mask"], as_arrays=True,
                                char_discount=no_lm["char_discount"])
        hyps = [list(h) or [CHAR_MAP["<eol>"]]
                for h, _ in best_hypotheses(out)[:4]]
        TL = max(len(h) for h in hyps)
        labels = np.zeros((4, TL), np.int64)
        lmask = np.zeros((4, TL), np.float32)
        for b, hyp in enumerate(hyps):
            labels[b, :len(hyp)] = hyp
            lmask[b, :len(hyp)] = 1.0
        batch["labels"] = torch.tensor(labels, device=dev)
        batch["labels_mask"] = t(lmask)
    train = train_batches(t, dev, 2, B=8, seed=20)
    # adadelta's first steps move each weight by about sqrt(epsilon) /
    # rms(gradient) * gradient.  Phase 13's max-norm constraint would
    # rescale the random weights (column norms near 1.6) on the first step
    # and change every hypothesis; without it, at SEARCH_TRAIN_EPSILON the
    # beam costs move but valid_per stays below the clipped 1
    config = dict(TRAIN_CONFIG, regularization={}, monitoring={
        "search": no_lm, "search_every_batches": 1})
    train_conf = dict(TRAIN_CONFIG["training"], epsilon=SEARCH_TRAIN_EPSILON)

    def train_with_search():
        rec_t = create_model({"net": net}, data, ckpt_again, device=dev)
        searched, search = [], rec_t.beam_search

        def recorded(*args, **kwargs):
            out = search(*args, **kwargs)
            searched.append(best_hypotheses(out)[:len(args[0])])
            return out
        rec_t.beam_search = recorded
        opt = build_optimizer(train_conf)
        with tempfile.TemporaryDirectory() as out_dir:
            loop = run_training(rec_t, opt, lambda: train, os.path.join(
                out_dir, "model.zip"), config, num_batches=2,
                valid_stream=lambda: valid, search_data=data,
                printing=False)
            files = sorted(os.listdir(out_dir))
        return loop.log.channel("valid_per"), files, searched

    with tempfile.TemporaryDirectory() as tmp2:
        ckpt_again = os.path.join(tmp2, "flagship.zip")
        save_checkpoint(ckpt_again, rec.param_path_dict())
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        per, files, searched = train_with_search()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        moved = counts(counters)
        with swapped(plain):
            ref_per, ref_files, ref_searched = train_with_search()
        t2 = time.perf_counter()
    if min(moved["beam_search_loop"], moved["gru_scan"]) < 1:
        fail(f"phase 18 training: the search did not launch its kernels: "
             f"{moved}")
    if len(searched) != 8 or len(ref_searched) != 8:
        fail(f"phase 18 training: {len(searched)} and {len(ref_searched)} "
             f"searches, expected 4 passes of 2 batches (before the first "
             f"epoch, after each step, after the epoch)")
    # each search of the kernel route against the plain route's: the same
    # hypotheses, beam costs within 1e-5 relative; after a step the costs
    # must have moved by 100 times that from those before it, so a search
    # on stale weights cannot pass
    worst, step_moved = 0.0, []
    for i, (got, ref) in enumerate(zip(searched, ref_searched)):
        for u, ((h, c), (rh, rc)) in enumerate(zip(got, ref)):
            if h != rh or (c is None) != (rc is None):
                fail(f"phase 18 training: search {i} (pass {i // 2}) "
                     f"utterance {u}: {h} ({c}) vs the plain route's {rh} "
                     f"({rc})")
            if c is not None:
                worst = max(worst, abs(c - rc) / abs(rc))
        if i >= 2:
            step_moved.append(max(
                (abs(c - c0) / abs(c0) for (_, c), (_, c0)
                 in zip(got, searched[i % 2]) if c is not None
                 and c0 is not None), default=0.0))
    if worst > 1e-5 or min(step_moved) <= 1e-3:
        fail(f"phase 18 training: beam costs within {worst:.2e} of the "
             f"plain route's, moved by {step_moved} after a step")
    if per != ref_per or files != ref_files or len(per[0]) != 3 or \
            per[1][0] != 0.0 or max(per[1][1:]) >= 1.0:
        fail(f"phase 18 training: valid_per {per} and files {files} vs the "
             f"plain route's {ref_per} and {ref_files}")
    log(f"phase 18 run_training, 2 steps (B=8, 800 frames, adadelta epsilon "
        f"{SEARCH_TRAIN_EPSILON}) with monitoring.search (beam 10, every "
        f"batch) on 2 validation batches of 4 (300-400 frames), kernel route "
        f"{t1 - t0:.1f} s, plain {t2 - t1:.1f} s: valid_per {per[1]} at "
        f"iterations {per[0]} on both routes, the same hypotheses in all 8 "
        f"searches, beam costs within {worst:.2e} relative, moved by "
        f"{[f'{m:.2e}' for m in step_moved]} after the steps; files {files}; "
        f"launches {moved}")
    log(f"phase 18 launches on the search paths: {search_launches}")
    return search_launches


# exp/wsj/configs/wsj_paper.yaml's sections (net: the flagship's, as
# __graft_entry__.FLAGSHIP_NET holds it) and its stages' deltas
WSJ_PAPER = {
    "regularization": {"max_norm": 1.0},
    "training": {"gradient_threshold": 100.0, "rules": ["adadelta"],
                 "decay_rate": 0.95, "epsilon": 1e-8, "seed": 1},
    "monitoring": {"validate_every_epochs": 1, "search_every_epochs": 1,
                   "search": {"beam_size": 10, "char_discount": 0.1,
                              "stop_on": "optimistic_future_cost"}}}
WSJ_PAPER_STAGES = (
    ("pretraining", {"net": {"prior": {
        "type": "expanding", "initial_begin": 0, "initial_end": 40,
        "min_speed": 1.2, "max_speed": 2.2}},
        "training": {"num_epochs": 1}}),
    ("main", {"training": {"restart_from": "_best_ll", "num_epochs": 10}}),
    ("annealing", {"training": {"epsilon": 1e-10, "restart_from": "_best_ll",
                                "num_epochs": 3}}))


def paper_stages(net, main_epochs=2, annealing_epochs=1):
    """(name, config) of wsj_paper.yaml's stages over ``net``, merged as
    ``Configuration.ordered_stages`` merges them, with main and annealing
    cut to ``main_epochs`` and ``annealing_epochs`` and char_discount 3.0
    (see phase 18: below it the random model's best hypothesis is
    empty)."""
    from attention_lvcsr_torch.config import merge_recursively
    base = copy.deepcopy(dict(WSJ_PAPER, net=net,
                              initialization=FLAGSHIP_INIT))
    base["monitoring"]["search"]["char_discount"] = 3.0
    cuts = {"main": main_epochs, "annealing": annealing_epochs}
    stages = []
    for name, delta in WSJ_PAPER_STAGES:
        stage = copy.deepcopy(base)
        merge_recursively(stage, copy.deepcopy(delta))
        if name in cuts:
            stage["training"]["num_epochs"] = cuts[name]
        stages.append((name, stage))
    return stages


def stage_batches(t, dev, n, B, seed, frames=500, labels=60):
    """``n`` batches of ``B`` utterances of 60-100 % of ``frames`` frames
    and 50-100 % of ``labels`` labels (row 0 the longest in both)."""
    import torch
    V = len(CHARS)
    rng = np.random.RandomState(seed)
    T, TL = frames, labels
    batches = []
    for _ in range(n):
        frames, labels = rng.randint(T * 3 // 5, T + 1, size=B), \
            rng.randint(TL // 2, TL + 1, size=B)
        frames[0], labels[0] = T, TL
        batches.append({
            "recordings": t(rng.randn(B, T, 123)),
            "recordings_mask": t(np.arange(T)[None] < frames[:, None]),
            "labels": torch.tensor(rng.randint(0, V - 1, size=(B, TL)),
                                   device=dev),
            "labels_mask": t(np.arange(TL)[None] < labels[:, None])})
    return batches


def multistage_phase(t, dev, rates):
    """Phase 19: the three stages of wsj_paper.yaml through
    ``run_multistage`` on the kernels, each stage's start and first step
    on the plain route, then the kernel route's ``main`` resumed after its
    first epoch.  Returns the kernel route's launches."""
    import torch
    from __graft_entry__ import FLAGSHIP_NET
    from attention_lvcsr_torch.models import cells as cells_mod
    from attention_lvcsr_torch.models import generator as generator_mod
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from attention_lvcsr_torch.ops import beam_loop as bl
    from attention_lvcsr_torch.ops import decoder_train as dt
    from attention_lvcsr_torch.ops import gru_scan as gs
    from attention_lvcsr_torch.ops import gru_train as gt
    from attention_lvcsr_torch.ops import outer_sum as osum
    from attention_lvcsr_torch.search import beam as beam_mod
    from attention_lvcsr_torch.train.checkpoint import (load_checkpoint,
                                                        save_checkpoint)
    from attention_lvcsr_torch.train.driver import (create_model,
                                                    run_multistage)

    counters = {"gru_scan": gs.launches, "beam_search_loop": bl.launches,
                "gru_scan_train_bidir": gt.launches_bidir,
                "decoder_scan_train": dt.launches, "outer_sum": osum.launches}
    plain = [(cells_mod, "gru_scan", gs.gru_scan_reference),
             (beam_mod, "beam_search_loop", bl.beam_search_loop_reference),
             (cells_mod, "gru_scan_train", gt.gru_scan_train_reference),
             (generator_mod, "decoder_scan_train",
              dt.decoder_scan_train_reference)]
    net = {k: v for k, v in FLAGSHIP_NET.items()
           if k not in ("input_dims", "input_num_chars", "eos_label",
                        "num_phonemes")}
    stages = paper_stages(net)
    data = SmokeData()
    B = 16
    train = stage_batches(t, dev, 2, B, seed=21)
    # validation on 4 of the training utterances: the steps lower their
    # cost, so that each stage writes the _best_ll checkpoint the next
    # one restarts from
    valid = [{k: v[:4] for k, v in train[0].items()}]

    def run(out_dir, start, searches, stage_list=stages, firsts=None,
            **kwargs):
        """run_multistage into ``out_dir``; each stage's search appends its
        best hypotheses to ``searches`` (and each stage the index of its
        first search to ``firsts``).  Returns (loops, [(stage, start
        time)], end time)."""
        marks = []

        def make_stage(config, load_path):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if firsts is not None:
                firsts.append(len(searches))
            rec = create_model(config, data, load_path, device=dev)
            search = rec.beam_search

            def recorded(*args, **kw):
                out = search(*args, **kw)
                searches.append(best_hypotheses(out)[:len(args[0])])
                return out
            rec.beam_search = recorded
            return dict(recognizer=rec, batch_stream=lambda: train,
                        valid_stream=lambda: valid, search_data=data)

        loops = run_multistage(stage_list, out_dir, make_stage, start,
                               printing=False, **kwargs)
        torch.cuda.synchronize()
        return loops, marks + [time.perf_counter()]

    tmp = tempfile.mkdtemp()
    try:
        start = os.path.join(tmp, "start.zip")
        rec = SpeechRecognizer(FLAGSHIP_NET, init_config=FLAGSHIP_INIT,
                               seed=1234, device=dev)
        rec.net.generator.readout.post_merge_0.bias.data[
            rec.eos_label] += 1.5
        save_checkpoint(start, rec.param_path_dict())
        del rec
        # the kernel route's stages, then on the plain route each stage's
        # start and first step from the checkpoint the kernel route's
        # stage loaded (``first_step``)
        searches, firsts = [], []
        for c in counters.values():
            c.reset()
        loops, marks = run(os.path.join(tmp, "kernels"), start, searches,
                           firsts=firsts)
        moved = counts(counters)
        files = sorted(os.listdir(os.path.join(tmp, "kernels")))
        ref_loops, ref_searches, spans = [], [], {
            "kernels": list(zip(marks, marks[1:])), "plain": []}
        for c in counters.values():
            c.reset()
        with swapped(plain):
            for number, (name, stage) in enumerate(stages):
                restart = stage["training"].get("restart_from", "")
                load = start if not number else os.path.join(
                    tmp, "kernels", f"{stages[number - 1][0]}{restart}.zip")
                got = []
                lps, mks = run(os.path.join(tmp, f"plain{number}"), load,
                               got, [(name, first_step(stage))])
                ref_loops += lps
                ref_searches.append(got)
                spans["plain"].append(tuple(mks))
        ref_moved = counts(counters)
        if min(moved.values()) < 1 or any(ref_moved.values()):
            fail(f"phase 19: launches {moved} on the kernels, {ref_moved} "
                 f"on the plain route")
        expected = {f"{name}{suffix}" for name, _ in stages for suffix in (
            ".zip", "_params.npz", "_best_ll.zip", "_best_ll_params.npz")}
        if not expected <= set(files):
            fail(f"phase 19: files {files}, expected {sorted(expected)}")
        compared, _, worst = first_steps_agree(
            "phase 19", stages, loops, ref_loops, searches, firsts,
            ref_searches)
        nonempty = sum(bool(h) for got in searches for h, _ in got)
        for route, lps in (("kernels", loops), ("plain", ref_loops)):
            for (name, _), lp, (t0, t1) in zip(stages, lps, spans[route]):
                steps = lp.log.status["iterations_done"]
                wall = t1 - t0
                step_s = float(np.median(
                    lp.log.channel("time_train_this_batch")[1]))
                rates[f"multistage_{route}_{name}_utt_per_s"] = \
                    B * steps / wall
                log(f"phase 19 {route} {name}: {wall:.2f} s for {steps} "
                    f"steps of B={B} ({lp.log.status['epochs_done']} epochs,"
                    f" validated and searched at iterations "
                    f"{lp.log.channel('valid_per')[0]}), "
                    f"{B * steps / wall:.2f} utt/s with validation and "
                    f"search, {B / step_s:.2f} utt/s in the steps (median "
                    f"{step_s:.4f} s); valid_per "
                    f"{[round(v, 4) for v in lp.log.channel('valid_per')[1]]}")
        log(f"phase 19 files: {files}; {len(searches)} searches, {compared} "
            f"hypotheses compared with the plain route's ({nonempty} of "
            f"{sum(len(g) for g in searches)} non-empty), beam costs within "
            f"{worst:.2e} relative; launches {moved}")

        # main stopped after its first epoch, then resumed
        main = dict(stages)["main"]
        first, resumed = os.path.join(tmp, "first"), os.path.join(
            tmp, "kernels")
        best = os.path.join(tmp, "kernels", "pretraining_best_ll.zip")
        main_first = copy.deepcopy(main)
        main_first["training"]["num_epochs"] = 1
        run(first, best, [], [("main", main_first)])
        again, _ = run(first, os.path.join(first, "main.zip"), [],
                       [("main", main)], use_load_ext=True)
        straight = load_checkpoint(os.path.join(resumed, "main.zip"))
        back = load_checkpoint(os.path.join(first, "main.zip"))
        same = set(back["parameters"]) == set(straight["parameters"]) and all(
            np.array_equal(back["parameters"][k], v)
            for k, v in straight["parameters"].items()) and all(
            np.array_equal(back["opt_state"][k], v)
            for k, v in straight["opt_state"].items())
        if not same or again[0].log.channel("train_cost") != \
                loops[1].log.channel("train_cost"):
            fail("phase 19: main resumed after its first epoch does not "
                 "give the bits of the straight run")
        log(f"phase 19 main stopped after epoch 1 and resumed "
            f"(use_load_ext, from {again[0].log.status['resumed_from']!r}"
            f"): parameters, optimizer state and train_cost at "
            f"{again[0].log.channel('train_cost')[0]} equal the straight "
            f"run's bit for bit")
    finally:
        shutil.rmtree(tmp)
    return moved



# The TIMIT recipe: exp/timit/configs/nips_baseline.yaml over
# attention_lvcsr_tpu/config/prototypes/prototype_speech.yaml, written out
# as dicts (no YAML): 123 fbank+deltas features, SpeechBottom [100] relu,
# a 3x250 BiGRU subsampled 1, 2, 2, content attention (match dim 250), a
# 250-unit GRU decoder without states in the readout, one post-merge
# layer of 250, the 61 TIMIT phones with BOS and EOS.
TIMIT_NET = {
    "bottom": {"bottom_class": "SpeechBottom", "dims": [100],
               "activation": "relu"},
    "enc_transition": "GatedRecurrent", "dec_transition": "GatedRecurrent",
    "dim_dec": 250, "dims_bidir": [250, 250, 250], "subsample": [1, 2, 2],
    "attention_type": "content", "use_states_for_readout": False,
    "post_merge_dims": [250], "max_decoded_length_scale": 3.0,
    "criterion": {"name": "log_likelihood"}, "lm": {}}
NIPS_BASELINE = {
    "regularization": {"dropout": False},
    "initialization": FLAGSHIP_INIT,
    "training": {"gradient_threshold": 100.0, "rules": ["adadelta"],
                 "decay_rate": 0.95, "epsilon": 1e-8, "scale": 0.01,
                 "momentum": 0.0},
    "monitoring": {"validate_every_epochs": 1, "search_every_epochs": 1,
                   "search": {"beam_size": 10, "char_discount": 0.0,
                              "round_to_inf": 1e9,
                              "stop_on": "optimistic_future_cost"}}}
NOISE = {"model_cost_coefficient": 0.1, "init_sigma": 1e-12}
NIPS_STAGES = (
    ("pretraining", {"data": {"batch_size": 8},
                     "regularization": {"max_norm": 1.0},
                     "training": {"num_epochs": 50}}),
    ("main", {"regularization": {"adaptive_noise": dict(NOISE)},
              "training": {"restart_from": "_best_ll", "num_epochs": 500}}),
    ("annealing", {"regularization": {"adaptive_noise": dict(NOISE)},
                   "training": {"epsilon": 1e-10, "restart_from": "_best_ll",
                                "num_epochs": 500}}))
TIMIT_TRAIN_UTTERANCES = 3696       # the training set's size (num_examples)


class TimitData(SmokeData):
    """SmokeData over the TIMIT phones; ``decode`` folds them to the
    39-phone scoring set, as the port's ``H5AudioDatasetTimit``."""

    def __init__(self):
        from attention_lvcsr_torch.data.h5 import TIMIT_61_TO_39
        self.fold = TIMIT_61_TO_39
        self.chars = sorted(TIMIT_61_TO_39) + ["<bol>", "<eol>"]
        self.char_map = {c: i for i, c in enumerate(self.chars)}
        self.bos_label = self.char_map["<bol>"]
        self.eos_label = self.char_map["<eol>"]
        self.num_labels = len(self.chars)

    def character_map(self, source):
        return dict(self.char_map)

    def decode(self, labels):
        out = []
        for x in labels:
            if int(x) in (self.eos_label, self.bos_label):
                continue
            phone = self.fold[self.chars[int(x)]]
            if phone:
                out.append(phone)
        return out

    def pretty_print(self, labels, example=None):
        return " ".join(self.decode(labels))


def nips_stages(epochs=1):
    """(name, config) of nips_baseline.yaml's stages over TIMIT_NET, merged
    as ``Configuration.ordered_stages`` merges them, each cut to
    ``epochs`` epochs, with char_discount 1.0 in place of the recipe's 0.0
    (below it the random model's best hypothesis is empty; at 3.0 its
    beams run to the decode cap and finish none: phase 20b)."""
    from attention_lvcsr_torch.config import merge_recursively
    base = copy.deepcopy(dict(NIPS_BASELINE, net=TIMIT_NET,
                              data={"batch_size": 16}))
    base["monitoring"]["search"]["char_discount"] = 1.0
    stages = []
    for name, delta in NIPS_STAGES:
        stage = copy.deepcopy(base)
        merge_recursively(stage, copy.deepcopy(delta))
        stage["training"]["num_epochs"] = epochs
        stages.append((name, stage))
    return stages


def timit_batches(t, dev, n, B, seed, V):
    """``n`` batches of ``B`` utterances of 300-700 frames and 20-75
    labels (row 0 the longest in both), each ending with the EOS label
    ``V - 1`` as the data streams end them."""
    import torch
    rng = np.random.RandomState(seed)
    batches = []
    for _ in range(n):
        frames, labels = rng.randint(300, 701, size=B), rng.randint(
            20, 76, size=B)
        frames[0], labels[0] = 700, 75
        symbols = rng.randint(0, V - 2, size=(B, 75))
        symbols[np.arange(B), labels - 1] = V - 1
        batches.append({
            "recordings": t(rng.randn(B, 700, 123)),
            "recordings_mask": t(np.arange(700)[None] < frames[:, None]),
            "labels": torch.tensor(symbols, device=dev),
            "labels_mask": t(np.arange(75)[None] < labels[:, None])})
    return batches


def timit_kernels(t, dev, results, data):
    """Phase 20a-b: the content branches of decoder_scan_train (forward
    and backward) and beam_search_loop against their plain versions at
    the recipe's shapes, with their layouts and times."""
    import torch
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from attention_lvcsr_torch.ops import beam_loop as bl
    from attention_lvcsr_torch.ops import decoder_train as dt

    # ---- a. the training decoder: B=16, T=75, L=175 (700 frames / 4)
    rng = np.random.RandomState(20)
    T, B, L, M, D, S = 75, 16, 175, 250, 500, 250
    ops, fixed, cots = decoder_operands(t, dev, rng, T=T, B=B, L=L, M=M,
                                        D=D, S=S)
    # no conv term: the band and the handler are zeros that feed nothing
    del ops["toep"], ops["hand"]
    fixed.update(toep=torch.zeros(L, L, device=dev),
                 hand=torch.zeros(1, M, device=dev),
                 w0=torch.zeros(B, L, device=dev))     # content glimpses
    names = list(ops)
    prior = {"type": "expanding", "initial_begin": 0, "initial_end": float(L),
             "min_speed": 0, "max_speed": 0}

    def scan(fn):
        def call(*xs):
            d = dict(zip(names, xs))
            return fn(d["fx"], d["fg"], fixed["mask"], d["pre"],
                      d["attended"], fixed["att_mask"], d["h0"], fixed["w0"],
                      d["wa0"], fixed["toep"], d["st"], fixed["hand"],
                      d["v"], d["wss"], d["wsg"], d["dxm"], d["dgm"],
                      prior=prior, n_filters=0)
        return call

    leaves = [ops[n] for n in names]
    dt.launches.reset()
    got, ggot = grads_of(scan(dt.decoder_scan_train), leaves, cots)
    if dt.launches.count != 2:
        fail(f"decoder_scan_train content branch: {dt.launches.count} "
             f"launches, expected a forward and a backward")
    ref, gref = grads_of(scan(dt.decoder_scan_train_reference), leaves, cots)
    outs = ("h", "weights", "wa", "energies")
    errs = relative_errors(
        dict(zip(outs, got), **{f"d{n}": g for n, g in zip(names, ggot)}),
        dict(zip(outs, ref), **{f"d{n}": g for n, g in zip(names, gref)}))
    log(f"phase 20a decoder_scan_train content branch T={T} B={B} L={L}: "
        f"max abs err over max abs value: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if not max(errs.values()) <= 1e-4:     # phase 12's tolerance
        fail("decoder_scan_train's content branch disagrees with its plain "
             "version")
    repeat("decoder_scan_train (content)", ggot,
           grads_of(scan(dt.decoder_scan_train), leaves, cots))
    abs_err = max(float((a - b).abs().max()) for a, b in
                  zip(list(got) + list(ggot), list(ref) + list(gref)))
    fwd, plain = scan(dt.decoder_scan_train), scan(
        dt.decoder_scan_train_reference)
    fwd_ms = cuda_ms(lambda: fwd(*leaves), 3)
    bwd_ms = backward_ms(fwd, leaves, cots, 3)
    plain_fwd = cuda_ms(lambda: plain(*leaves), 1)
    plain_bwd = backward_ms(plain, leaves, cots, 1)
    alone = {}
    with timed_launches(dt, 5, alone):
        grads_of(fwd, leaves, cots)
    row_ops = attention_step_ops(S, M, L, 0, D) + 2 * D * 3 * S \
        + gru_step_ops(S)
    n_ops = T * B * row_ops
    inputs = [fixed[n] for n in ("mask", "att_mask", "w0")]
    fwd_bytes = nbytes(*leaves, *inputs) + nbytes(*got) + 3 * nbytes(got[0])
    bwd_bytes = nbytes(*leaves, *inputs, *cots, *got) \
        + 3 * nbytes(got[0]) + nbytes(*gref)
    plans = {kind: dt.launch_plan(kind, B, L, M, D, S, dev, n_filters=0)
             for kind in dt.KINDS}
    results["decoder_scan_train"]["content"] = {
        "B": B, "T": T, "L": L, "max_abs_err": abs_err,
        "max_rel_err": max(errs.values()), "ms": fwd_ms + bwd_ms,
        "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
        "fwd_kernel_ms": alone["decoder_train_fwd_f32"],
        "bwd_kernel_ms": alone["decoder_train_bwd_f32"],
        "plain_ms": plain_fwd + plain_bwd, "plain_fwd_ms": plain_fwd,
        "plain_bwd_ms": plain_bwd, **bound(fwd_bytes + bwd_bytes, 4 * n_ops),
        "library_ms": None,
        **{f"{k}_blocks": p["blocks"] for k, p in plans.items()},
        **{f"{k}_smem_bytes": p["smem_bytes"] for k, p in plans.items()}}
    r = results["decoder_scan_train"]["content"]
    log(f"  forward {fwd_ms:.3f} ms (kernel alone {r['fwd_kernel_ms']:.3f}),"
        f" autograd backward {bwd_ms:.3f} ms (kernel alone "
        f"{r['bwd_kernel_ms']:.3f}); plain {plain_fwd:.3f} + "
        f"{plain_bwd:.3f} ms; bound {r['bound_ms']:.3f} ms; plans "
        + "; ".join(f"{k}: {p['clusters']} clusters of {p['cluster']}, "
                    f"{p['smem_bytes']} bytes a block, the card holds at "
                    f"once {dt.max_active_clusters(k, dev, n_filters=0)}"
                    for k, p in plans.items()))

    # ---- b. the whole-loop decode: beam 10 at U=16 and 64, L=175, with
    # char_discount 1.0: at 3.0 every hypothesis of the random content
    # model runs to the cap repeating one symbol, and the done sets hold
    # costs within float32 rounding of each other (inputs and tables
    # scaled by 1 + 1e-6 noise change 6 of 64 utterances' done sets in the
    # plain version itself); at 1.0 they change none, and the searches
    # still run 100-130 steps
    net = dict(TIMIT_NET, input_dims={"recordings": 123},
               eos_label=data.eos_label, num_phonemes=data.num_labels,
               character_map=data.character_map("labels"))
    rec = SpeechRecognizer(net, init_config=FLAGSHIP_INIT, seed=1234,
                           device=dev)
    loop_err = 0.0
    for U in (16, 64):
        feats = t(np.random.RandomState(U).randn(U, 700, 123))
        frames = np.random.RandomState(U + 1).randint(300, 701, size=U)
        frames[0] = 700
        fmask = t(np.arange(700)[None] < frames[:, None])
        with torch.inference_mode():
            d = rec.net.decode_loop(feats, fmask)
            tables = dict(rec.net.decode_loop_tables())
        tables["post_b"] = tables["post_b"].clone()
        tables["post_b"][data.eos_label] += 1.5
        Lu = d["pre"].shape[1]
        kw = dict(beam=10, max_len=int(700 / 3.0), eol=data.eos_label,
                  ignore_first_eol=True, stop_on="optimistic_future_cost",
                  char_discount=1.0, prior="expanding",
                  initial_end=float(Lu) + 1.0, content_attention=True)
        loop_args = (d["pre"], d["attended"], d["attended_mask"], tables)

        def as_out(res):
            out, meta, steps = (x.cpu().numpy() for x in res)
            return {"done_out": out, "done_cost": meta[:, :, 0],
                    "done_adjusted": meta[:, :, 1],
                    "done_len": meta[:, :, 2].astype(np.int32),
                    "done_valid": meta[:, :, 1] < bl.INF / 2,
                    "steps": steps}

        bl.launches.reset()
        got = as_out(bl.beam_search_loop(*loop_args, **kw))
        if bl.launches.count != 1:
            fail("beam_search_loop content branch: no launch")
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        ref = as_out(bl.beam_search_loop_reference(*loop_args, **kw))
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        name = f"beam_search_loop content U={U}"
        err = compare_outputs(name, got, ref)
        loop_err = max(loop_err, err)
        finished = int(got["done_valid"].any(axis=1).sum())
        ms = cuda_ms(lambda: bl.beam_search_loop(*loop_args, **kw), 3)
        log(f"phase 20b {name} L={Lu}: outputs agree; {finished}/{U} "
            f"utterances finished, steps {int(got['steps'].min())}.."
            f"{int(got['steps'].max())}, max abs cost err {err:.3e}; kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
        if finished < U * 3 // 4:
            fail(f"{name}: only {finished}/{U} utterances finished: the "
                 f"comparison is too weak")
        if U == 64:
            R, V = 250, data.num_labels
            plan = beam_loop_plan(dict(
                K=10, L=Lu, M=M, D=D, S=S, R=R, V=V,
                F=tables["embed"].shape[1], Lout=kw["max_len"], n_taps=0,
                content=1), content=True)
            row_ops = (attention_step_ops(S, M, Lu, 0, D)
                       + readout_ops(D, R, V) + 2 * (D + S) * 3 * S
                       + gru_step_ops(S) + 3 * V)
            loop_out = bl.beam_search_loop(*loop_args, **kw)
            results["beam_search_loop"]["content"] = {
                "U": U, "L": Lu, "ms": ms, "plain_ms": plain_ms,
                **bound(nbytes(*loop_args[:3], tables, *loop_out),
                        10 * int(got["steps"].sum()) * row_ops),
                "library_ms": None, **plan}
    results["beam_search_loop"]["content"]["max_abs_err"] = loop_err


def timit_phase(t, dev, results, rates):
    """Phase 20: the TIMIT recipe (nips_baseline.yaml) at its full widths:
    the content branches of the two kernels (a, b), its three stages
    through ``run_multistage`` on the kernels (each stage's start and
    first step on the plain route) and ``main`` resumed after an epoch
    (c), and ``run_search`` on the result (d).  Returns the kernel route's
    launches in c and d."""
    import torch
    from attention_lvcsr_torch.models import cells as cells_mod
    from attention_lvcsr_torch.models import generator as generator_mod
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from attention_lvcsr_torch.ops import beam_loop as bl
    from attention_lvcsr_torch.ops import decoder_train as dt
    from attention_lvcsr_torch.ops import gru_scan as gs
    from attention_lvcsr_torch.ops import gru_train as gt
    from attention_lvcsr_torch.ops import outer_sum as osum
    from attention_lvcsr_torch.search import beam as beam_mod
    from attention_lvcsr_torch.train.checkpoint import (load_checkpoint,
                                                        save_checkpoint)
    from attention_lvcsr_torch.train.driver import (create_model,
                                                    run_multistage,
                                                    run_search)

    data = TimitData()
    t0 = time.perf_counter()
    timit_kernels(t, dev, results, data)
    log(f"phase 20a-b: {time.perf_counter() - t0:.1f} s")

    # ---- c. the three stages ---------------------------------------------
    t0 = time.perf_counter()
    counters = {"gru_scan": gs.launches, "beam_search_loop": bl.launches,
                "gru_scan_train_bidir": gt.launches_bidir,
                "decoder_scan_train": dt.launches, "outer_sum": osum.launches}
    plain = [(cells_mod, "gru_scan", gs.gru_scan_reference),
             (beam_mod, "beam_search_loop", bl.beam_search_loop_reference),
             (cells_mod, "gru_scan_train", gt.gru_scan_train_reference),
             (generator_mod, "decoder_scan_train",
              dt.decoder_scan_train_reference)]
    stages = nips_stages()
    sizes = {name: stage["data"]["batch_size"] for name, stage in stages}
    batches = {B: timit_batches(t, dev, 2, B, 20 + B, data.num_labels)
               for B in set(sizes.values())}
    valid = [{k: v[:4] for k, v in batches[16][0].items()}]

    def run(out_dir, start, searches, stage_list=stages, validate=True,
            firsts=None, **kwargs):
        marks = []

        def make_stage(config, load_path):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if firsts is not None:
                firsts.append(len(searches))
            rec = create_model(config, data, load_path, device=dev)
            search = rec.beam_search

            def recorded(*args, **kw):
                out = search(*args, **kw)
                searches.append(best_hypotheses(out)[:len(args[0])])
                return out
            rec.beam_search = recorded
            train = batches[config["data"]["batch_size"]]
            return dict(recognizer=rec, batch_stream=lambda: train,
                        valid_stream=(lambda: valid) if validate else None,
                        search_data=data,
                        num_examples=TIMIT_TRAIN_UTTERANCES)

        loops = run_multistage(stage_list, out_dir, make_stage, start,
                               printing=False, **kwargs)
        torch.cuda.synchronize()
        return loops, marks + [time.perf_counter()]

    tmp = tempfile.mkdtemp()
    try:
        start = os.path.join(tmp, "start.zip")
        rec = SpeechRecognizer(
            dict(TIMIT_NET, input_dims={"recordings": 123},
                 eos_label=data.eos_label, num_phonemes=data.num_labels,
                 character_map=data.character_map("labels")),
            init_config=FLAGSHIP_INIT, seed=1234, device=dev)
        rec.net.generator.readout.post_merge_0.bias.data[
            data.eos_label] += 1.5
        save_checkpoint(start, rec.param_path_dict())
        del rec
        # the kernel route's stages, then on the plain route each stage's
        # start and first step from the checkpoint the kernel route's
        # stage loaded (``first_step``)
        searches, firsts = [], []
        for c in counters.values():
            c.reset()
        loops, marks = run(os.path.join(tmp, "kernels"), start, searches,
                           firsts=firsts)
        moved = counts(counters)
        files = sorted(os.listdir(os.path.join(tmp, "kernels")))
        ref_loops, ref_searches, spans = [], [], {
            "kernels": list(zip(marks, marks[1:])), "plain": []}
        for c in counters.values():
            c.reset()
        with swapped(plain):
            for number, (name, stage) in enumerate(stages):
                restart = stage["training"].get("restart_from", "")
                load = start if not number else os.path.join(
                    tmp, "kernels", f"{stages[number - 1][0]}{restart}.zip")
                got = []
                lps, mks = run(os.path.join(tmp, f"plain{number}"), load,
                               got, [(name, first_step(stage))])
                ref_loops += lps
                ref_searches.append(got)
                spans["plain"].append(tuple(mks))
        ref_moved = counts(counters)
        if min(moved.values()) < 1 or any(ref_moved.values()):
            fail(f"phase 20c: launches {moved} on the kernels, {ref_moved} "
                 f"on the plain route")
        expected = {f"{name}{suffix}" for name, _ in stages for suffix in (
            ".zip", "_params.npz")}
        if not expected <= set(files):
            fail(f"phase 20c: files {files}, expected {sorted(expected)}")
        for number, (name, _) in enumerate(stages):
            keys = [set(load_checkpoint(path)["parameters"]) for path in (
                os.path.join(tmp, "kernels", f"{name}.zip"),
                os.path.join(tmp, f"plain{number}", f"{name}.zip"))
                if os.path.exists(path)]
            noisy = any(k.startswith("/adaptive_noise/") for k in keys[0])
            if any(k != keys[0] for k in keys) or \
                    noisy == (name == "pretraining"):
                fail(f"phase 20c {name}: keys differ or the noise is "
                     f"{'present' if noisy else 'missing'}")
        # pretraining has no model_cost, the noisy stages have one
        worst = max(first_steps_agree(
            "phase 20c", stages[:1], loops, ref_loops, searches, firsts,
            ref_searches)[2], first_steps_agree(
            "phase 20c", stages[1:], loops[1:], ref_loops[1:], searches,
            firsts[1:], ref_searches[1:],
            ("train_cost", "total_gradient_norm",
             "valid_sequence_total_cost", "model_cost"))[2])
        for route, lps in (("kernels", loops), ("plain", ref_loops)):
            for (name, _), lp, (s0, s1) in zip(stages, lps, spans[route]):
                steps, B = lp.log.status["iterations_done"], sizes[name]
                step_s = float(np.median(
                    lp.log.channel("time_train_this_batch")[1]))
                rates[f"timit_{route}_{name}_utt_per_s"] = \
                    B * steps / (s1 - s0)
                log(f"phase 20c {route} {name}: {s1 - s0:.2f} s for {steps} "
                    f"steps of B={B}, {B * steps / (s1 - s0):.2f} utt/s "
                    f"with validation and search, {B / step_s:.2f} utt/s in "
                    f"the steps (median {step_s:.4f} s); valid_per "
                    f"{[round(v, 4) for v in lp.log.channel('valid_per')[1]]}"
                    f"; model_cost "
                    f"{lp.log.channel('model_cost')[1][-1:] or None}")
        nonempty = sum(bool(h) for got in searches for h, _ in got)
        searched = sum(len(g) for g in searches)
        pers = [p for lp in loops for p in lp.log.channel("valid_per")[1]]
        # the random model finds nothing after pretraining's max-norm
        # step, and its first restart (main's first search) starts there
        if nonempty < searched // 2 or min(pers) >= 1.0:
            fail(f"phase 20c: {nonempty} of {searched} hypotheses non-empty, "
                 f"valid_per {pers}: the comparison is too weak")
        log(f"phase 20c files {files}; {len(searches)} searches, "
            f"{sum(len(g) for g in ref_searches)} of them "
            f"with the plain route's hypotheses ({nonempty} of {searched} "
            f"non-empty), beam costs within {worst:.2e} relative; launches "
            f"{moved}")

        # main straight for two epochs, and stopped after one and resumed
        # (without validation and search, which the stages compared above)
        main = copy.deepcopy(dict(stages)["main"])
        main["training"]["num_epochs"] = 2
        best = os.path.join(tmp, "kernels", "pretraining_best_ll.zip")
        straight_dir, first = (os.path.join(tmp, n) for n in ("straight",
                                                              "first"))
        straight, _ = run(straight_dir, best, [], [("main", main)],
                          validate=False)
        main_first = copy.deepcopy(main)
        main_first["training"]["num_epochs"] = 1
        run(first, best, [], [("main", main_first)], validate=False)
        again, _ = run(first, os.path.join(first, "main.zip"), [],
                       [("main", main)], validate=False, use_load_ext=True)
        a = load_checkpoint(os.path.join(straight_dir, "main.zip"))
        b = load_checkpoint(os.path.join(first, "main.zip"))
        same = set(a["parameters"]) == set(b["parameters"]) and all(
            np.array_equal(b["parameters"][k], v)
            for k, v in a["parameters"].items()) and all(
            np.array_equal(b["opt_state"][k], v)
            for k, v in a["opt_state"].items())
        for key in ("train_cost", "model_cost"):
            same = same and again[0].log.channel(key) == \
                straight[0].log.channel(key)
        if not same:
            fail("phase 20c: main resumed after its first epoch does not "
                 "give the bits of the straight run")
        log(f"phase 20c main stopped after epoch 1 and resumed: parameters, "
            f"log-variances, optimizer state, train_cost and model_cost at "
            f"{again[0].log.channel('train_cost')[0]} equal the straight "
            f"run's bit for bit")
        log(f"phase 20c: {time.perf_counter() - t0:.1f} s")

        # ---- d. run_search on the last stage's model ---------------------
        t0 = time.perf_counter()
        rng = np.random.RandomState(20)
        examples = []
        for i in range(8):
            n, k = rng.randint(300, 701), rng.randint(20, 76)
            examples.append({
                "recordings": rng.randn(n, 123).astype(np.float32),
                "labels": np.concatenate([
                    [data.bos_label], rng.randint(0, data.bos_label, size=k),
                    [data.eos_label]]).astype(np.int64),
                "uttids": f"utt{i:02d}"})
        search_conf = dict(stages[2][1]["monitoring"]["search"],
                           decode_batch=4)
        model = os.path.join(tmp, "kernels", "annealing.zip")
        reports = {}
        for route in ("kernels", "plain"):
            for c in counters.values():
                c.reset()
            with swapped(plain if route == "plain" else []):
                rec = create_model(stages[2][1], data, model, device=dev)
                out = io.StringIO()
                torch.cuda.synchronize()
                s0 = time.perf_counter()
                stats = run_search(rec, examples, data, search_conf,
                                   print_to=out)
                torch.cuda.synchronize()
                wall = time.perf_counter() - s0
            reports[route] = (out.getvalue(), stats, counts(counters), wall)
            rates[f"timit_search_{route}_utt_per_s"] = len(examples) / wall
        (text, stats, search_moved, wall), (ref_text, ref_stats, ref_sm,
                                            ref_wall) = (reports["kernels"],
                                                         reports["plain"])
        if min(search_moved[k] for k in ("gru_scan", "beam_search_loop",
                                         "gru_scan_train_bidir",
                                         "decoder_scan_train")) < 1 \
                or any(ref_sm.values()):
            fail(f"phase 20d: launches {search_moved} on the kernels, "
                 f"{ref_sm} on the plain route")
        err = reports_agree("phase 20d run_search", text, ref_text,
                            list(range(len(examples))), stats, ref_stats)
        recognized = sum(bool(u.get("Recognized"))
                         for u in parse_report(text))
        if recognized < len(examples) * 3 // 4:
            fail(f"phase 20d: {recognized} of {len(examples)} hypotheses "
                 f"non-empty: the comparison is too weak")
        log(f"phase 20d run_search decode_batch 4 over {len(examples)} "
            f"utterances: the same report on both routes ({recognized} "
            f"non-empty hypotheses, costs within "
            f"{err:.2e} relative, CER {stats['total_errors']}/"
            f"{stats['total_length']}); {len(examples) / wall:.2f} utt/s on "
            f"the kernels, {len(examples) / ref_wall:.2f} on the plain "
            f"route; launches {search_moved}; {time.perf_counter() - t0:.1f}"
            f" s")
    finally:
        shutil.rmtree(tmp)
    return {k: moved.get(k, 0) + search_moved.get(k, 0)
            for k in set(moved) | set(search_moved)}


# ---- phase 21: the task loss ----------------------------------------------

ICLR_NET = dict(TIMIT_NET, attention_type="content_and_conv", conv_n=100,
                conv_num_filters=1, energy_normalizer="logistic",
                criterion={"name": "mse_gain", "min_reward": -5})
ICLR = {
    "regularization": {"dropout": False},
    "initialization": dict(FLAGSHIP_INIT, **{
        "/recognizer/generator/readout": {"biases_init": ["Constant",
                                                          -1.0]}}),
    "training": {"gradient_threshold": 100.0, "rules": ["adadelta"],
                 "decay_rate": 0.95, "epsilon": 1e-8, "scale": 0.01,
                 "momentum": 0.0, "exploration": "greedy"},
    "monitoring": {"validate_every_epochs": 1, "search_every_epochs": 1,
                   "search": {"beam_size": 10, "char_discount": 0.0,
                              "round_to_inf": 4.5, "stop_on": "patience"}}}
ICLR_STAGES = (
    ("pretraining", {"data": {"batch_size": 8},
                     "regularization": {"max_norm": 1.0},
                     "training": {"num_epochs": 30},
                     "net": {"criterion": {"min_reward": -1}}}),
    ("pretraining2", {"data": {"batch_size": 8},
                      "training": {"num_epochs": 30,
                                   "restart_from": "_best_ll"}}))
# wsj_reward1.yaml over wsj_paper1.yaml: the gain-MSE criterion, uniform
# weights and a pessimistic post-merge bias, the rule's scale 0.01
WSJ_REWARD_INIT = {
    "/recognizer": {"weights_init": ["uniform", 0.0, 0.1],
                    "biases_init": ["constant", 0.0],
                    "rec_weights_init": ["orthogonal"]},
    "/recognizer/generator/readout/post_merge_0": {
        "biases_init": ["constant", -1.0]}}


def iclr_stages(epochs=1):
    """(name, config) of iclr_reward.yaml's first two stages over
    ICLR_NET, merged as ``Configuration.ordered_stages`` merges them, each
    cut to ``epochs`` epochs."""
    from attention_lvcsr_torch.config import merge_recursively
    base = copy.deepcopy(dict(ICLR, net=ICLR_NET, data={"batch_size": 16}))
    stages = []
    for name, delta in ICLR_STAGES:
        stage = copy.deepcopy(base)
        merge_recursively(stage, copy.deepcopy(delta))
        stage["training"]["num_epochs"] = epochs
        stages.append((name, stage))
    return stages


def routing_check(t, dev):
    """Phase 21a: a no-LM decode past a block's shared memory (the
    flagship at beam 20) runs the loop kernel's workspace instance, and
    finds the plain loop's hypotheses."""
    import torch
    from __graft_entry__ import FLAGSHIP_NET
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from attention_lvcsr_torch.ops import attention_energy as ae
    from attention_lvcsr_torch.ops import beam_loop as bl
    from attention_lvcsr_torch.search import beam as beam_mod
    U, frames, K = 16, 800, 20
    rec = SpeechRecognizer(dict(FLAGSHIP_NET, max_decoded_length_scale=8.0),
                           init_config=FLAGSHIP_INIT, seed=1234, device=dev)
    rec.net.generator.readout.post_merge_0.bias.data[rec.eos_label] += 1.5
    max_len = int(frames / 8.0)
    if not (beam_mod.loop_route(rec.net_config, K, frames)
            and beam_mod.loop_route(rec.net_config, 10, frames)):
        fail("phase 21a: the routing predicate leaves the loop kernel at "
             "beam 20 or 10")
    rng = np.random.RandomState(21)
    lengths = rng.randint(600, frames + 1, size=U)
    lengths[0] = frames
    feats = t(rng.randn(U, frames, 123))
    fmask = t(np.arange(frames)[None] < lengths[:, None])
    rec.init_beam_search(K)
    bl.launches.reset()
    bl.launches_ws.reset()
    ae.launches.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = rec.beam_search(feats, fmask, as_arrays=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if bl.launches.count or bl.launches_ws.count != 1 or ae.launches.count:
        fail(f"phase 21a: beam 20 launched the loop's resident instance "
             f"{bl.launches.count} times, its workspace instance "
             f"{bl.launches_ws.count} times and beam_attention_energies "
             f"{ae.launches.count} times: not the workspace instance")
    prior = rec.net.generator.attention.prior_config()
    with torch.inference_mode():
        data = rec.net.decode_loop(feats, fmask)
        ref = bl.beam_search_loop_reference(
            data["pre"], data["attended"], data["attended_mask"],
            rec.net.decode_loop_tables(), beam=K, max_len=max_len,
            eol=rec.eos_label, ignore_first_eol=rec.data_prepend_eos,
            prior=prior["type"], before=float(prior["before"]),
            after=float(prior["after"]))
    out, meta, steps = (x.cpu().numpy() for x in ref)
    ref = {"done_out": out, "done_cost": meta[:, :, 0],
           "done_adjusted": meta[:, :, 1],
           "done_len": meta[:, :, 2].astype(np.int32),
           "done_valid": meta[:, :, 1] < bl.INF / 2}
    best_g, best_r = best_hypotheses(got), best_hypotheses(ref)
    differ, worst = [], 0.0
    for u, ((h, c), (rh, rc)) in enumerate(zip(best_g, best_r)):
        if h == rh and (c is None) == (rc is None) and (
                c is None or abs(c - rc) <= 1e-4 * max(abs(rc), 1.0)):
            worst = max(worst, 0.0 if c is None else abs(c - rc))
            continue
        if c is None or rc is None or abs(c - rc) > 1e-3 * max(abs(rc), 1):
            fail(f"phase 21a: utterance {u}: {h} ({c}) on the workspace "
                 f"instance vs {rh} ({rc}) on the plain loop")
        differ.append(u)
    found = sum(c is not None for _, c in best_r)
    if len(differ) > 1 or found < U * 3 // 4:
        fail(f"phase 21a: {len(differ)} near ties, {found}/{U} utterances "
             f"finished")
    log(f"phase 21a beam {K} at U={U}, {frames} frames: the loop kernel's "
        f"workspace instance ({int(got['steps'])} steps) in {wall:.2f} s; "
        f"best hypotheses equal "
        f"the plain loop's ({found}/{U} finished, near ties {differ}, "
        f"costs within {worst:.2e})")
    return wall


def loop_branches(t, dev, results, data):
    """Phase 21b: beam_loop.cu's mse_cost + logistic branch and its relu
    branch against their plain versions at the TIMIT widths, U=64,
    L=175, beam 10."""
    import torch
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from attention_lvcsr_torch.ops import beam_loop as bl
    U, frames, K = 64, 700, 10
    feats = t(np.random.RandomState(U).randn(U, frames, 123))
    lengths = np.random.RandomState(U + 1).randint(300, frames + 1, size=U)
    lengths[0] = frames
    fmask = t(np.arange(frames)[None] < lengths[:, None])
    # the mse model's costs are its negated readouts: where a symbol's
    # readout is above 0 every step lowers a hypothesis's cost, the
    # random model's beams run to the cap, and its done sets hold costs
    # within float32 rounding of each other (near 500 a float32 step is
    # 3e-5: on an H100 the kernel and the plain version ordered 9 of 64
    # utterances' done sets differently); lowering every readout but
    # EOS's by 4 makes each step cost ~5 and the searches stop on
    # patience
    cases = {"mse_logistic": (dict(energy_normalizer="logistic"),
                              ICLR["initialization"], 4.0),
             "relu": (dict(energy_normalizer="relu",
                           criterion={"name": "log_likelihood"}),
                      FLAGSHIP_INIT, 0.0)}
    for name, (over, init, lower) in cases.items():
        net = dict(ICLR_NET, input_dims={"recordings": 123},
                   eos_label=data.eos_label, num_phonemes=data.num_labels,
                   character_map=data.character_map("labels"), **over)
        rec = SpeechRecognizer(net, init_config=init, seed=1234,
                               device=dev)
        normalizer = net["energy_normalizer"]
        mse = rec.net.generator.mse
        with torch.inference_mode():
            d = rec.net.decode_loop(feats, fmask)
            tables = dict(rec.net.decode_loop_tables())
        tables["post_b"] = tables["post_b"] - lower
        tables["post_b"][data.eos_label] += lower + 1.5
        L = d["pre"].shape[1]
        kw = dict(beam=K, max_len=int(frames / 3.0), eol=data.eos_label,
                  ignore_first_eol=True, stop_on="patience",
                  char_discount=0.0 if mse else 1.0, round_to_inf=4.5,
                  normalizer=normalizer, mse_cost=mse)
        loop_args = (d["pre"], d["attended"], d["attended_mask"], tables)

        def as_out(res):
            out, meta, steps = (x.cpu().numpy() for x in res)
            return {"done_out": out, "done_cost": meta[:, :, 0],
                    "done_adjusted": meta[:, :, 1],
                    "done_len": meta[:, :, 2].astype(np.int32),
                    "done_valid": meta[:, :, 1] < bl.INF / 2,
                    "steps": steps}

        bl.launches.reset()
        got = as_out(bl.beam_search_loop(*loop_args, **kw))
        if bl.launches.count != 1:
            fail(f"beam_search_loop {name}: no launch")
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        ref = as_out(bl.beam_search_loop_reference(*loop_args, **kw))
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        err = compare_outputs(f"beam_search_loop {name}", got, ref)
        finished = int(got["done_valid"].any(axis=1).sum())
        if finished < U * 3 // 4:
            fail(f"beam_search_loop {name}: only {finished}/{U} utterances "
                 f"finished: the comparison is too weak")
        ms = cuda_ms(lambda: bl.beam_search_loop(*loop_args, **kw), 3)
        S, M, D, R, V = 250, 250, 500, 250, data.num_labels
        plan = beam_loop_plan(dict(
            K=K, L=L, M=M, D=D, S=S, R=R, V=V, F=tables["embed"].shape[1],
            Lout=kw["max_len"], n_taps=tables["conv_filters"].shape[-1]),
            normalizer=normalizer, phase="21b")
        row_ops = (attention_step_ops(S, M, L, 201, D)
                   + readout_ops(D, R, V) + 2 * (D + S) * 3 * S
                   + gru_step_ops(S) + 3 * V)
        out = bl.beam_search_loop(*loop_args, **kw)
        results["beam_search_loop"][name] = {
            "U": U, "L": L, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms,
            **bound(nbytes(*loop_args[:3], tables, *out),
                    K * int(got["steps"].sum()) * row_ops),
            "library_ms": None, **plan}
        r = results["beam_search_loop"][name]
        log(f"phase 21b beam_search_loop {name} U={U} L={L}: outputs agree; "
            f"{finished}/{U} finished, steps {int(got['steps'].min())}.."
            f"{int(got['steps'].max())}, max abs cost err {err:.3e}; kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{r['bound_ms']:.3f} ms")


def decoder_branches(t, dev, results):
    """Phase 21c: decoder_train.cu's logistic and relu branches, forward
    and backward, against the plain version at B=16, T=75, L=175 (the
    TIMIT decoder, 201 taps, the full-window prior of nips_conv.yaml)."""
    from attention_lvcsr_torch.ops import decoder_train as dt
    rng = np.random.RandomState(21)
    T, B, L, M, D, S = 75, 16, 175, 250, 500, 250
    ops, fixed, cots = decoder_operands(t, dev, rng, T=T, B=B, L=L, M=M,
                                        D=D, S=S)
    prior = {"type": "expanding", "initial_begin": 0, "initial_end": 10000,
             "min_speed": 0, "max_speed": 0}
    # the operands' states saturate, so a row's energies move together
    # (about 1.3 apart between rows); relu's bias keeps every row's
    # numerators above zero, where a row of zeros divides 0 by 0 (NaN) in
    # both versions, as in the JAX package
    for normalizer, bias in (("logistic", -0.3), ("relu", 6.0)):
        ops["e_bias"] = t([bias])
        names = list(ops)

        def scan(fn):
            def call(*xs):
                d = dict(zip(names, xs))
                return fn(d["fx"], d["fg"], fixed["mask"], d["pre"],
                          d["attended"], fixed["att_mask"], d["h0"],
                          fixed["w0"], d["wa0"], d["toep"], d["st"],
                          d["hand"], d["v"], d["wss"], d["wsg"], d["dxm"],
                          d["dgm"], prior=prior, e_bias=d["e_bias"],
                          normalizer=normalizer)
            return call

        leaves = [ops[n] for n in names]
        dt.launches.reset()
        got, ggot = grads_of(scan(dt.decoder_scan_train), leaves, cots)
        if dt.launches.count != 2:
            fail(f"decoder_scan_train {normalizer}: {dt.launches.count} "
                 f"launches, expected a forward and a backward")
        ref, gref = grads_of(scan(dt.decoder_scan_train_reference), leaves,
                             cots)
        outs = ("h", "weights", "wa", "energies")
        state_errs = relative_errors(dict(zip(outs, got)),
                                     dict(zip(outs, ref)))
        grad_errs = relative_errors(
            {f"d{n}": g for n, g in zip(names, ggot)},
            {f"d{n}": g for n, g in zip(names, gref)})
        log(f"phase 21c decoder_scan_train {normalizer} T={T} B={B} L={L}: "
            f"max abs err over max abs value: "
            + ", ".join(f"{k} {v:.2e}" for k, v in
                        {**state_errs, **grad_errs}.items()))
        if not (max(state_errs.values()) <= 1e-5
                and max(grad_errs.values()) <= 1e-4):
            fail(f"decoder_scan_train's {normalizer} branch disagrees with "
                 f"its plain version")
        repeat(f"decoder_scan_train ({normalizer})", ggot,
               grads_of(scan(dt.decoder_scan_train), leaves, cots))
        abs_err = max(float((a - b).abs().max()) for a, b in
                      zip(list(got) + list(ggot), list(ref) + list(gref)))
        fwd, plain = scan(dt.decoder_scan_train), scan(
            dt.decoder_scan_train_reference)
        fwd_ms = cuda_ms(lambda: fwd(*leaves), 3)
        bwd_ms = backward_ms(fwd, leaves, cots, 3)
        plain_fwd = cuda_ms(lambda: plain(*leaves), 1)
        plain_bwd = backward_ms(plain, leaves, cots, 1)
        alone = {}
        with timed_launches(dt, 5, alone):
            grads_of(fwd, leaves, cots)
        n_ops = T * B * (attention_step_ops(S, M, L, L, D) + 2 * D * 3 * S
                         + gru_step_ops(S))
        fwd_bytes = nbytes(*leaves, *fixed.values()) + nbytes(*got) \
            + 4 * nbytes(got[0])
        bwd_bytes = nbytes(*leaves, *fixed.values(), *cots, *got) \
            + 4 * nbytes(got[0]) + nbytes(*gref)
        results["decoder_scan_train"][normalizer] = {
            "B": B, "T": T, "L": L, "max_abs_err": abs_err,
            "max_rel_err_states": max(state_errs.values()),
            "max_rel_err_grads": max(grad_errs.values()),
            "ms": fwd_ms + bwd_ms, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
            "fwd_kernel_ms": alone["decoder_train_fwd_f32"],
            "bwd_kernel_ms": alone["decoder_train_bwd_f32"],
            "plain_ms": plain_fwd + plain_bwd, "plain_fwd_ms": plain_fwd,
            "plain_bwd_ms": plain_bwd,
            **bound(fwd_bytes + bwd_bytes, 4 * n_ops), "library_ms": None}
        r = results["decoder_scan_train"][normalizer]
        log(f"  forward {fwd_ms:.3f} ms (kernel alone "
            f"{r['fwd_kernel_ms']:.3f}), autograd backward {bwd_ms:.3f} ms "
            f"(kernel alone {r['bwd_kernel_ms']:.3f}); plain "
            f"{plain_fwd:.3f} + {plain_bwd:.3f} ms; bound "
            f"{r['bound_ms']:.3f} ms")


def reward_check(dev, rates):
    """Phase 21d: the device reward/gain DP against the host numpy DP on
    a B=16 batch of random hypotheses (TIMIT's 63 symbols, 75-step
    groundtruths, 85-step hypotheses): equal integers; its time and its
    device launches (torch.profiler)."""
    import torch
    from attention_lvcsr_torch.ops.error_rate import \
        batch_reward_and_gain_rows as batch_reward_and_gain
    from attention_lvcsr_torch.ops.reward_op import reward_and_gain
    rng = np.random.RandomState(21)
    B, T_g, T_r, A = 16, 75, 85, 63
    gt = rng.randint(0, A - 1, size=(T_g, B))
    gt[rng.randint(20, T_g, size=B), np.arange(B)] = A - 1
    rec = rng.randint(0, A, size=(T_r, B))
    rec[rng.randint(0, T_r, size=B // 2), np.arange(B // 2)] = A - 1
    ref = batch_reward_and_gain(gt, rec, A, A - 1)
    g, r = (torch.tensor(x, device=dev) for x in (gt, rec))
    got = reward_and_gain(g, r, A)
    if not all(np.array_equal(a.cpu().numpy(), b) for a, b in zip(got, ref)):
        fail("phase 21d: the device reward/gain DP differs from the host DP")
    ms = cuda_ms(lambda: reward_and_gain(g, r, A), 5)
    t0 = time.perf_counter()
    batch_reward_and_gain(gt, rec, A, A - 1)
    host_ms = (time.perf_counter() - t0) * 1e3
    kernels = None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        reward_and_gain(g, r, A)
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if events:
        kernels = len(events)
    rates["reward_dp_ms"] = ms
    rates["reward_dp_launches"] = kernels
    log(f"phase 21d reward_and_gain B={B} T_g={T_g} T_r={T_r} A={A}: equal "
        f"to the host DP; {ms:.3f} ms on the card ({kernels} device "
        f"launches by torch.profiler), host numpy {host_ms:.1f} ms")


def run_stages(dev, data, stages, batches, valid, out_dir, start, searches,
               started=None, **kwargs):
    """``run_multistage`` over in-memory batches, recording every search's
    best hypotheses (and, into ``started``, each stage's first search's
    index in ``searches`` and the checkpoint it loaded): (loops, stage
    start and end times)."""
    import torch
    from attention_lvcsr_torch.train.driver import (create_model,
                                                    run_multistage)
    marks = []

    def make_stage(config, load_path):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if started is not None:
            started.append((len(searches), load_path))
        rec = create_model(config, data, load_path, device=dev)
        search = rec.beam_search

        def recorded(*args, **kw):
            out = search(*args, **kw)
            searches.append(best_hypotheses(out)[:len(args[0])])
            return out
        rec.beam_search = recorded
        train = batches[config["data"]["batch_size"]]
        return dict(recognizer=rec, batch_stream=lambda: train,
                    valid_stream=(lambda: valid) if valid else None,
                    search_data=data,
                    num_examples=TIMIT_TRAIN_UTTERANCES)

    loops = run_multistage(stages, out_dir, make_stage, start,
                           printing=False, **kwargs)
    torch.cuda.synchronize()
    return loops, marks + [time.perf_counter()]


def iclr_stages_check(t, dev, rates, data):
    """Phase 21e: iclr_reward.yaml's two pretraining stages with greedy
    exploration on the kernels (each stage's start and first step on the
    plain route), then pretraining2 resumed after an epoch.  Returns the
    kernel route's launches."""
    from attention_lvcsr_torch.models import attention as attention_mod
    from attention_lvcsr_torch.models import cells as cells_mod
    from attention_lvcsr_torch.models import generator as generator_mod
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from attention_lvcsr_torch.ops import attention_energy as ae
    from attention_lvcsr_torch.ops import beam_loop as bl
    from attention_lvcsr_torch.ops import decoder_train as dt
    from attention_lvcsr_torch.ops import gru_scan as gs
    from attention_lvcsr_torch.ops import gru_train as gt
    from attention_lvcsr_torch.ops import outer_sum as osum
    from attention_lvcsr_torch.search import beam as beam_mod
    from attention_lvcsr_torch.train.checkpoint import (load_checkpoint,
                                                        save_checkpoint)
    counters = {"gru_scan": gs.launches, "beam_search_loop": bl.launches,
                "beam_attention_energies": ae.launches,
                "gru_scan_train_bidir": gt.launches_bidir,
                "decoder_scan_train": dt.launches, "outer_sum": osum.launches}
    plain = [(cells_mod, "gru_scan", gs.gru_scan_reference),
             (beam_mod, "beam_search_loop", bl.beam_search_loop_reference),
             (attention_mod, "beam_attention_energies",
              ae.beam_attention_energies_reference),
             (cells_mod, "gru_scan_train", gt.gru_scan_train_reference),
             (generator_mod, "decoder_scan_train",
              dt.decoder_scan_train_reference)]
    stages = iclr_stages()
    batches = {8: timit_batches(t, dev, 2, 8, 21, data.num_labels)}
    valid = [{k: v[:4] for k, v in batches[8][0].items()}]
    tmp = tempfile.mkdtemp()
    try:
        start = os.path.join(tmp, "start.zip")
        rec = SpeechRecognizer(
            dict(ICLR_NET, input_dims={"recordings": 123},
                 eos_label=data.eos_label, num_phonemes=data.num_labels,
                 character_map=data.character_map("labels")),
            init_config=ICLR["initialization"], seed=1234, device=dev)
        rec.net.generator.readout.post_merge_0.bias.data[
            data.eos_label] += 1.5
        save_checkpoint(start, rec.param_path_dict())
        del rec
        # the kernel route's stages, then on the plain route each stage's
        # start and first step from the checkpoint the kernel route's
        # stage loaded (``first_step``)
        searches, started = [], []
        for c in counters.values():
            c.reset()
        loops, marks = run_stages(dev, data, stages, batches, valid,
                                  os.path.join(tmp, "kernels"), start,
                                  searches, started=started)
        moved = counts(counters)
        ref_loops, ref_searches, spans = [], [], {
            "kernels": list(zip(marks, marks[1:])), "plain": []}
        for c in counters.values():
            c.reset()
        with swapped(plain):
            for number, (name, stage) in enumerate(stages):
                got = []
                lps, mks = run_stages(
                    dev, data, [(name, first_step(stage))], batches, valid,
                    os.path.join(tmp, f"plain{number}"),
                    started[number][1], got)
                ref_loops += lps
                ref_searches.append(got)
                spans["plain"].append(tuple(mks))
        ref_moved = counts(counters)
        if min(moved.values()) < 1 or any(ref_moved.values()):
            fail(f"phase 21e: launches {moved} on the kernels, {ref_moved} "
                 f"on the plain route")
        compared, _, worst = first_steps_agree(
            "phase 21e", stages, loops, ref_loops, searches,
            [first for first, _ in started], ref_searches)
        nonempty = sum(bool(h) for got in searches for h, _ in got)
        searched = sum(len(g) for g in searches)
        if nonempty <= searched // 2:
            fail(f"phase 21e: {nonempty} of {searched} hypotheses non-empty: "
                 f"the comparison is too weak")
        for route, lps in (("kernels", loops), ("plain", ref_loops)):
            for (name, stage), lp, (s0, s1) in zip(stages, lps,
                                                   spans[route]):
                steps = lp.log.status["iterations_done"]
                B = stage["data"]["batch_size"]
                step_s = float(np.median(
                    lp.log.channel("time_train_this_batch")[1]))
                rates[f"iclr_{route}_{name}_utt_per_s"] = \
                    B * steps / (s1 - s0)
                rates[f"iclr_{route}_{name}_step_utt_per_s"] = B / step_s
                log(f"phase 21e {route} {name}: {s1 - s0:.2f} s for {steps} "
                    f"steps of B={B}, {B * steps / (s1 - s0):.2f} utt/s with "
                    f"validation and search, {B / step_s:.2f} utt/s in the "
                    f"steps (median {step_s:.4f} s); valid_per "
                    f"{[round(v, 4) for v in lp.log.channel('valid_per')[1]]}")
        log(f"phase 21e: {len(searches)} searches ({nonempty} of "
            f"{searched} hypotheses non-empty), {compared} hypotheses "
            f"compared with the plain route's, beam costs within "
            f"{worst:.2e} relative; launches {moved}")

        # pretraining2 straight for two epochs, and stopped after one and
        # resumed, without validation
        second = copy.deepcopy(dict(stages)["pretraining2"])
        second["training"]["num_epochs"] = 2
        best = os.path.join(tmp, "kernels", "pretraining_best_ll.zip")
        straight_dir, first = (os.path.join(tmp, n) for n in ("straight",
                                                              "first"))
        straight, _ = run_stages(dev, data, [("pretraining2", second)],
                                 batches, None, straight_dir, best, [])
        cut = copy.deepcopy(second)
        cut["training"]["num_epochs"] = 1
        run_stages(dev, data, [("pretraining2", cut)], batches, None, first,
                   best, [])
        again, _ = run_stages(dev, data, [("pretraining2", second)],
                              batches, None, first,
                              os.path.join(first, "pretraining2.zip"), [],
                              use_load_ext=True)
        a = load_checkpoint(os.path.join(straight_dir, "pretraining2.zip"))
        b = load_checkpoint(os.path.join(first, "pretraining2.zip"))
        same = all(np.array_equal(b["parameters"][k], v)
                   for k, v in a["parameters"].items()) and all(
            np.array_equal(b["opt_state"][k], v)
            for k, v in a["opt_state"].items()) and \
            again[0].log.channel("train_cost") == \
            straight[0].log.channel("train_cost")
        if not same:
            fail("phase 21e: pretraining2 resumed after its first epoch "
                 "does not give the bits of the straight run")
        log("phase 21e pretraining2 stopped after epoch 1 and resumed: "
            "parameters, optimizer state and train_cost equal the straight "
            "run's bit for bit")
    finally:
        shutil.rmtree(tmp)
    return moved


def wsj_reward_steps(t, dev, rates):
    """Phase 21f: one wsj_reward3.yaml step (greedy) and one
    wsj_reward_mixed.yaml step at the flagship widths, B=32, 800 frames,
    100 labels, on the kernels and on the plain route."""
    import torch
    from __graft_entry__ import FLAGSHIP_NET
    from attention_lvcsr_torch.models import attention as attention_mod
    from attention_lvcsr_torch.models import cells as cells_mod
    from attention_lvcsr_torch.models import generator as generator_mod
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from attention_lvcsr_torch.ops import attention_energy as ae
    from attention_lvcsr_torch.ops import decoder_train as dt
    from attention_lvcsr_torch.ops import gru_scan as gs
    from attention_lvcsr_torch.ops import gru_train as gt
    from attention_lvcsr_torch.train.driver import (GradientDescent,
                                                    make_train_step)
    from attention_lvcsr_torch.train.rules import build_optimizer
    counters = {"gru_scan": gs.launches, "beam_attention_energies":
                ae.launches, "gru_scan_train_bidir": gt.launches_bidir,
                "decoder_scan_train": dt.launches}
    plain = [(cells_mod, "gru_scan", gs.gru_scan_reference),
             (attention_mod, "beam_attention_energies",
              ae.beam_attention_energies_reference),
             (cells_mod, "gru_scan_train", gt.gru_scan_train_reference),
             (generator_mod, "decoder_scan_train",
              dt.decoder_scan_train_reference)]
    batch = train_batches(t, dev, 1, seed=21)[0]
    V = FLAGSHIP_NET["num_phonemes"]
    # rows end with EOS, as the data streams end them
    last = (batch["labels_mask"].sum(1) - 1).long()
    batch["labels"][torch.arange(last.shape[0], device=dev), last] = V - 1
    net = dict(FLAGSHIP_NET, criterion={"name": "mse_gain",
                                        "min_reward": -5})
    for exploration in ("greedy", "mixed"):
        config = {"net": net, "regularization": {"max_norm": 1.0},
                  "training": {"gradient_threshold": 100.0,
                               "rules": ["adadelta"], "decay_rate": 0.95,
                               "epsilon": 1e-8, "scale": 0.01,
                               "exploration": exploration}}
        out = {}
        for route in ("kernels", "plain"):
            for c in counters.values():
                c.reset()
            with swapped(plain if route == "plain" else []):
                rec = SpeechRecognizer(net, init_config=WSJ_REWARD_INIT,
                                       seed=1234, device=dev)
                opt = build_optimizer(config["training"],
                                      config["regularization"])
                gd = GradientDescent(rec, opt,
                                     make_train_step(rec, opt, config))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mon = gd.process_batch(batch)
                torch.cuda.synchronize()
                out[route] = (mon, time.perf_counter() - t0,
                              counts(counters))
        (mon, wall, moved), (ref, ref_wall, ref_moved) = (out["kernels"],
                                                          out["plain"])
        if min(moved.values()) < 1 or any(ref_moved.values()):
            fail(f"phase 21f {exploration}: launches {moved} on the "
                 f"kernels, {ref_moved} on the plain route")
        for key in ("train_cost", "total_gradient_norm", "mask_density"):
            rel = abs(mon[key] - ref[key]) / abs(ref[key])
            if not (np.isfinite(mon[key]) and rel <= 1e-4):
                fail(f"phase 21f {exploration}: {key} {mon[key]} vs plain "
                     f"{ref[key]}")
        rates[f"wsj_reward_{exploration}_step_s"] = wall
        log(f"phase 21f wsj_reward {exploration} step B=32: train_cost "
            f"{mon['train_cost']:.6g} vs plain {ref['train_cost']:.6g}, "
            f"total_gradient_norm {mon['total_gradient_norm']:.6g} vs "
            f"{ref['total_gradient_norm']:.6g}, mask_density "
            f"{mon['mask_density']:.4f}; {wall:.2f} s on the kernels, "
            f"{ref_wall:.2f} s plain; launches {moved}")


def task_loss_phase(t, dev, results, rates):
    """Phase 21: the task loss.  Returns the kernel route's launches in
    21e."""
    t0 = time.perf_counter()
    data = TimitData()
    routing_check(t, dev)
    loop_branches(t, dev, results, data)
    decoder_branches(t, dev, results)
    reward_check(dev, rates)
    log(f"phase 21a-d: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moved = iclr_stages_check(t, dev, rates, data)
    log(f"phase 21e: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    wsj_reward_steps(t, dev, rates)
    log(f"phase 21f: {time.perf_counter() - t0:.1f} s")
    return moved


# ---- phase 22: the readout and attention variants of the WSJ recipes ------

MEAN_MAXOUT_PRETRAINING = {"type": "expanding", "initial_begin": 0,
                           "initial_end": 100, "min_speed": 3,
                           "max_speed": 5.5}


def variant_nets():
    """The nets of phase 22 over the flagship's (``FLAGSHIP_NET``):

    * ``mean_maxout``, exp/wsj/configs/wsj_mean_maxout.yaml's over
      wsj_paper.yaml's: a 4x256 encoder, a 512-dim matcher, ten conv
      filters, the decoder states in a maxout:2 readout, the window around
      the mean (its pretraining stage the expanding window
      ``MEAN_MAXOUT_PRETRAINING``);
    * ``bhd4``, wsj_bhd4.yaml's: the flagship's widths, the decoder states
      in a rectifier readout, the expanding window;
    * ``good``, wsj_good.yaml's: one 250-unit BiGRU layer over a 250-unit
      rectifier bottom, no subsampling, the decoder states in a readout
      without a post-merge layer, the expanding window."""
    from __graft_entry__ import FLAGSHIP_NET
    return {
        "mean_maxout": dict(
            FLAGSHIP_NET, dims_bidir=[256] * 4, dim_dec=256, dim_matcher=512,
            conv_num_filters=10, use_states_for_readout=True,
            post_merge_dims=[256], post_merge_activation="maxout:2",
            prior={"type": "window_around_mean", "before": 150,
                   "after": 150}),
        "bhd4": dict(FLAGSHIP_NET, use_states_for_readout=True,
                     post_merge_activation="rectifier",
                     prior={"type": "expanding", "initial_begin": 0,
                            "initial_end": 40, "min_speed": 1.2,
                            "max_speed": 2.2}),
        "good": dict(FLAGSHIP_NET, dims_bidir=[250], subsample=[1],
                     bottom={"bottom_class": "speech", "dims": [250],
                             "activation": "rectifier"},
                     use_states_for_readout=True, post_merge_dims=None,
                     prior={"type": "expanding", "initial_begin": 0,
                            "initial_end": 200, "min_speed": 6,
                            "max_speed": 11})}


# their rule chains: wsj_paper.yaml's for wsj_mean_maxout.yaml, momentum
# (scale 0.1) then adadelta for wsj_bhd4.yaml and wsj_good.yaml, which
# max-norms its weights
MOMENTUM_ADADELTA = {"gradient_threshold": 100.0, "scale": 0.1,
                     "momentum": 0.0, "rules": ["momentum", "adadelta"],
                     "decay_rate": 0.95, "epsilon": 1e-8}


def loop_row_ops(net, width, D):
    """Operations of one hypothesis row and step of a conv-attention
    decode loop (``net``'s widths) whose window spans ``width`` frames: the attention step over the
    window (each filter's convolution, the taps clipped to the window as
    ``decode_step.cuh::window_conv_filters`` clips them, and its handler
    term), the readout (the states' merge, the activation, the post-merge
    layer of R / k rows under maxout), the GRU advance with its fork and
    distribute products, and the selection; a stack of N layers has N
    layers' states in the state products and N advances, each layer
    above the first with its interlayer products (2 * S * 3S)."""
    from attention_lvcsr_torch.ops.expressions import maxout_pieces
    S, V = net["dim_dec"], net["num_phonemes"]
    N = net.get("dec_stack") or 1
    M = net.get("dim_matcher") or S
    R = net["post_merge_dims"][0]
    nf, n = net.get("conv_num_filters") or 1, net["conv_n"]
    taps = sum(min(width - 1, l + n) - max(0, l - n) + 1
               for l in range(width))
    readout = 2 * D * R + R + 2 * (R // (maxout_pieces(
        net.get("post_merge_activation") or "tanh") or 1)) * V + 3 * V
    if net.get("use_states_for_readout"):
        readout += 2 * N * S * R
    # attention_step_ops' terms with the conv and handler terms per filter
    return (2 * N * S * M + 2 * nf * taps + (4 + 2 * nf) * width * M
            + 4 * width + 2 * width * D + readout
            + N * (2 * (D + S) * 3 * S + gru_step_ops(S))
            + (N - 1) * 2 * S * 3 * S + 3 * V)


def loop_ops(net, K, D, widths, steps):
    """Operations of a conv-attention decode, K rows a step of each
    utterance for its ``steps``, each step over its window (``widths``, the plain
    loop's (U,) window widths of each step), and the mean window."""
    import torch
    W = torch.stack(widths).cpu().numpy()       # (steps run, U)
    live = np.concatenate([W[:int(n), u] for u, n in enumerate(steps)])
    values, counts = np.unique(live, return_counts=True)
    ops = sum(int(c) * loop_row_ops(net, int(w), D)
              for w, c in zip(values, counts))
    return K * ops, float(live.mean()) if live.size else 0.0


def loop_case(dev, results, phase, name, net, feats, fmask, K, max_len,
              min_finished, repeats=3, eos_bias=1.5):
    """The loop kernel's decode of ``net`` (random weights from seed 1234,
    the EOS logit raised by ``eos_bias``) against the plain loop on the same card
    tensors, compared as in phase 3 (at least ``min_finished`` utterances
    must finish), a second launch bit for bit, the C layout of the
    instance ``ops/beam_loop.py::route`` takes, the times (``repeats``
    launches) and the bound over each step's window, into ``results``
    (``beam_search_loop``, or ``beam_search_loop_ws`` for the workspace
    instance)."""
    import torch
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from attention_lvcsr_torch.ops import beam_loop as bl
    from attention_lvcsr_torch.ops.expressions import maxout_pieces
    U = feats.shape[0]
    rec = SpeechRecognizer(dict(net, max_decoded_length_scale=8.0),
                           init_config=FLAGSHIP_INIT, seed=1234, device=dev)
    with torch.inference_mode():
        d = rec.net.decode_loop(feats, fmask)
        tables = dict(rec.net.decode_loop_tables())
    tables["post_b"] = tables["post_b"].clone()
    tables["post_b"][rec.eos_label] += eos_bias
    prior = rec.net.generator.attention.prior_config()
    act = net.get("post_merge_activation") or "tanh"
    N = net.get("dec_stack") or 1
    kw = dict(beam=K, max_len=max_len, eol=rec.eos_label,
              ignore_first_eol=True, post_act=act, prior=prior["type"],
              **{k: float(v) for k, v in prior.items() if k != "type"})
    loop_args = (d["pre"], d["attended"], d["attended_mask"], tables)
    L, M, D = d["pre"].shape[1], d["pre"].shape[2], d["attended"].shape[2]
    code, pieces = bl.post_act_code(act)
    nf = net.get("conv_num_filters") or 1
    dims = dict(K=K, L=L, M=M, D=D, S=net["dim_dec"],
                R=net["post_merge_dims"][0], V=rec.num_phonemes,
                F=tables["embed"].shape[1], Lout=kw["max_len"],
                n_taps=tables["conv_filters"].shape[-1])
    instance = bl.route(bl.smem_plan(**dims, n_filters=nf, maxout=pieces,
                                     dec_stack=N), K)
    counter, idle = ((bl.launches, bl.launches_ws) if instance == "resident"
                     else (bl.launches_ws, bl.launches))
    key = "beam_search_loop" + ("" if instance == "resident" else "_ws")

    def as_out(res):
        out, meta, steps = (x.cpu().numpy() for x in res)
        return {"done_out": out, "done_cost": meta[:, :, 0],
                "done_adjusted": meta[:, :, 1],
                "done_len": meta[:, :, 2].astype(np.int32),
                "done_valid": meta[:, :, 1] < bl.INF / 2, "steps": steps}

    counter.reset()
    idle.reset()
    got = as_out(bl.beam_search_loop(*loop_args, **kw))
    if counter.count != 1 or idle.count:
        fail(f"beam_search_loop {name}: no launch of the {instance} "
             f"instance")
    widths = []                 # each step's window, for the bound
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    start.record()
    ref = as_out(bl.beam_search_loop_reference(*loop_args, **kw,
                                               window_widths=widths))
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    err = compare_outputs(f"beam_search_loop {name}", got, ref,
                          reorder=phase == "25a")
    finished = int(got["done_valid"].any(axis=1).sum())
    if finished < min_finished:
        fail(f"beam_search_loop {name}: only {finished}/{U} utterances "
             f"finished: the comparison is too weak")
    again = as_out(bl.beam_search_loop(*loop_args, **kw))
    if not all(np.array_equal(got[k], again[k]) for k in got):
        fail(f"beam_search_loop {name}: a second launch differs")
    ms = cuda_ms(lambda: bl.beam_search_loop(*loop_args, **kw), repeats)
    plan = beam_loop_plan(dims, phase=phase, n_filters=nf, post_act=code,
                          maxout=pieces, dec_stack=N, instance=instance)
    out = bl.beam_search_loop(*loop_args, **kw)
    ops, window = loop_ops(net, K, D, widths, got["steps"])
    results.setdefault(key, {})[name] = {
        "U": U, "K": K, "L": L, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms,
        **bound(nbytes(*loop_args[:3], tables, *out), ops),
        "mean_window": window, "library_ms": None, **plan}
    r = results[key][name]
    if instance == "workspace":
        r["workspace_bytes"] = 4 * U * plan["workspace_stride"]
    log(f"phase {phase} beam_search_loop {name} ({instance}; {N} layers of "
        f"{net['dim_dec']}, {nf} filters, {act}, {prior['type']}) U={U} "
        f"K={K} L={L}: outputs agree; {finished}/{U} finished, steps "
        f"{int(got['steps'].min())}..{int(got['steps'].max())}, max abs "
        f"cost err {err:.3e}, a second launch bit for bit; kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {r['bound_ms']:.3f} "
        f"ms over windows of {r['mean_window']:.1f} of {L} frames on "
        f"average ({maxout_pieces(act) or 'no'} maxout pieces)"
        + (f"; workspace {r['workspace_bytes']} bytes"
           if instance == "workspace" else ""))
    return r


def variant_loops(t, dev, results):
    """Phase 22a: beam_loop.cu's new branches against the plain loop at
    U=64, 800 frames, beam 10, 100 steps: ten filters + maxout:2 + the
    states readout at wsj_mean_maxout's widths under the mean and the
    expanding prior, and the rectifier, sigmoid and identity post-merge
    activations at wsj_bhd4's."""
    U, frames, K = 64, 800, 10
    rng = np.random.RandomState(22)
    feats = t(rng.randn(U, frames, 123))
    lengths = rng.randint(600, frames + 1, size=U)
    lengths[0] = frames
    fmask = t(np.arange(frames)[None] < lengths[:, None])
    nets = variant_nets()
    mean_maxout, bhd4 = nets["mean_maxout"], nets["bhd4"]
    cases = {"maxout10_mean": mean_maxout,
             "maxout10_expanding": dict(mean_maxout,
                                        prior=MEAN_MAXOUT_PRETRAINING),
             "rectifier": bhd4,
             "sigmoid": dict(bhd4, post_merge_activation="sigmoid"),
             "identity": dict(bhd4, post_merge_activation="identity")}
    for name, net in cases.items():
        loop_case(dev, results, "22a", name, net, feats, fmask, K,
                  frames // 8, U * 3 // 4)


def decoder_case(t, dev, results, phase, key, prior, T, B, L, M, D, S,
                 nf=10, taps=201, N=1):
    """decoder_train.cu's forward and backward with ``nf`` filters and
    ``N`` GRU layers against the plain scan: states within 1e-5 and every
    gradient within 1e-4 of its largest value (the taps', the handler's
    and a stack's interlayer tables' included), a second call bit for
    bit; the launch plans, the C layouts against the mirror, the times,
    into ``results["decoder_scan_train"][key]``."""
    import torch
    from attention_lvcsr_torch.ops import decoder_train as dt
    rng = np.random.RandomState(22 + B + 10 * (N - 1))
    ops, fixed, cots = decoder_operands(t, dev, rng, T=T, B=B, L=L, M=M,
                                        D=D, S=S, taps=taps, N=N)
    # the filters' bands, side by side, and their handler rows
    filters = t(rng.randn(nf, taps) * 0.1)
    ops["toep"] = torch.cat([dt.toeplitz_band(filters[f], L)
                             for f in range(nf)], dim=1)
    ops["hand"] = t(rng.randn(nf, M) * 0.1)
    names = list(ops)

    def scan(fn):
        def call(*xs):
            d = dict(zip(names, xs))
            return fn(d["fx"], d["fg"], fixed["mask"], d["pre"],
                      d["attended"], fixed["att_mask"], d["h0"],
                      fixed["w0"], d["wa0"], d["toep"], d["st"], d["hand"],
                      d["v"], d["wss"], d["wsg"], d["dxm"], d["dgm"],
                      prior=prior, n_filters=nf, dec_stack=N,
                      inter_in=d.get("inter_in"),
                      inter_gate=d.get("inter_gate"))
        return call

    plans = {}
    for kind in dt.KINDS:
        p = dt.launch_plan(kind, B, L, M, D, S, dev, n_filters=nf,
                           dec_stack=N)
        res = {k: p.get(f"res_{k}", 0) for k in dt.TILES[kind]}
        check_decoder_layout(kind, B, L, M, D, S, p, res, nf, N)
        plans[kind] = p
        log(f"phase {phase} decoder_scan_train {kind} plan {key}: "
            f"{p['clusters']} clusters of {p['cluster']} blocks, "
            f"{p['rows']} rows a cluster, resident {res}, "
            f"{p['smem_bytes']} bytes a block (C equals the mirror)")
    leaves = [ops[n] for n in names]
    dt.launches.reset()
    got, ggot = grads_of(scan(dt.decoder_scan_train), leaves, cots)
    if dt.launches.count != 2:
        fail(f"decoder_scan_train {key}: {dt.launches.count} launches, "
             f"expected a forward and a backward")
    ref, gref = grads_of(scan(dt.decoder_scan_train_reference), leaves, cots)
    outs = ("h", "weights", "wa", "energies")
    state_errs = relative_errors(dict(zip(outs, got)), dict(zip(outs, ref)))
    grad_errs = relative_errors(
        {f"d{n}": g for n, g in zip(names, ggot)},
        {f"d{n}": g for n, g in zip(names, gref)})
    log(f"phase {phase} decoder_scan_train {key} ({nf} filters, {N} "
        f"layers of {S}, {prior['type']}) T={T} B={B} L={L}: max abs err "
        f"over max abs value: " + ", ".join(
            f"{k} {v:.2e}" for k, v in {**state_errs, **grad_errs}.items()))
    if not (max(state_errs.values()) <= 1e-5
            and max(grad_errs.values()) <= 1e-4):
        fail(f"decoder_scan_train {key} disagrees with its plain version")
    repeat(f"decoder_scan_train ({key})", ggot,
           grads_of(scan(dt.decoder_scan_train), leaves, cots))
    abs_err = max(float((a - b).abs().max()) for a, b in
                  zip(list(got) + list(ggot), list(ref) + list(gref)))
    fwd, plain = scan(dt.decoder_scan_train), scan(
        dt.decoder_scan_train_reference)
    fwd_ms = cuda_ms(lambda: fwd(*leaves), 3)
    bwd_ms = backward_ms(fwd, leaves, cots, 3)
    plain_fwd = cuda_ms(lambda: plain(*leaves), 1)
    plain_bwd = backward_ms(plain, leaves, cots, 1)
    alone = {}
    with timed_launches(dt, 5, alone):
        grads_of(fwd, leaves, cots)
    # one step of one row: the attention step with its bands (2 L^2 each)
    # and handler terms, the N layers' distribute products and GRU steps
    # and the N - 1 interlayer products; the backward recomputes the
    # attention step and does twice the products
    row_ops = attention_step_ops(N * S, M, L, nf * L, D) \
        + 2 * (nf - 1) * L * M + N * (2 * D * 3 * S + gru_step_ops(S)) \
        + (N - 1) * 2 * S * 3 * S
    n_ops = T * B * row_ops
    fwd_bytes = nbytes(*leaves, *fixed.values()) + nbytes(*got) \
        + 3 * nbytes(got[0])
    bwd_bytes = nbytes(*leaves, *fixed.values(), *cots, *got) \
        + 3 * nbytes(got[0]) + nbytes(*gref)
    results["decoder_scan_train"][key] = {
        "B": B, "T": T, "L": L, "S": S, "dec_stack": N,
        "max_abs_err": abs_err,
        "max_rel_err_states": max(state_errs.values()),
        "max_rel_err_grads": max(grad_errs.values()),
        "ms": fwd_ms + bwd_ms, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
        "fwd_kernel_ms": alone["decoder_train_fwd_f32"],
        "bwd_kernel_ms": alone["decoder_train_bwd_f32"],
        "plain_ms": plain_fwd + plain_bwd, "plain_fwd_ms": plain_fwd,
        "plain_bwd_ms": plain_bwd,
        **bound(fwd_bytes + bwd_bytes, 4 * n_ops), "library_ms": None,
        **{f"{k}_plan": {x: p[x] for x in ("cluster", "clusters", "rows",
                                            "smem_bytes")}
           for k, p in plans.items()}}
    r = results["decoder_scan_train"][key]
    log(f"  forward {fwd_ms:.3f} ms (kernel alone {r['fwd_kernel_ms']:.3f}), "
        f"autograd backward {bwd_ms:.3f} ms (kernel alone "
        f"{r['bwd_kernel_ms']:.3f}); plain {plain_fwd:.3f} + "
        f"{plain_bwd:.3f} ms; bound {r['bound_ms']:.3f} ms")
    return r


def variant_decoder(t, dev, results):
    """Phase 22b: decoder_train.cu's ten filters under the mean prior,
    forward and backward, against the plain scan at wsj_mean_maxout's
    decoder (T=100 labels, L=200 frames, M=512, D=512, S=256, 201 taps) at
    B=10 and B=32 (``decoder_case``)."""
    prior = variant_nets()["mean_maxout"]["prior"]
    for B in (10, 32):
        decoder_case(t, dev, results, "22b", f"filters10_mean_B{B}", prior,
                     T=100, B=B, L=200, M=512, D=512, S=256)


def check_decoder_layout(kind, B, L, M, D, S, plan, res, n_filters, N=1):
    """The decoder kernel's C shared-memory layout of a plan against the
    mirror (``ops/decoder_train.py::layout``); ``N`` GRU layers."""
    import ctypes
    from attention_lvcsr_torch import _build
    from attention_lvcsr_torch.ops import decoder_train as dt
    lib = _build.load().lib
    lib.decoder_train_smem_bytes.argtypes = [ctypes.c_int,
                                             ctypes.POINTER(dt._Args)]
    lib.decoder_train_smem_bytes.restype = ctypes.c_int
    c_bytes = lib.decoder_train_smem_bytes(dt.KINDS.index(kind), ctypes.byref(
        dt._Args(B=B, L=L, M=M, D=D, S=S, cluster=plan["cluster"],
                 clusters=plan["clusters"], n_filters=n_filters,
                 dec_stack=N, **{f"res_{k}": v for k, v in res.items()})))
    want = dt.layout(kind, plan["cluster"], plan["rows"], L, M, D, S, res,
                     n_filters=n_filters, dec_stack=N)["smem_bytes"]
    if c_bytes != want or c_bytes != plan["smem_bytes"]:
        fail(f"decoder_scan_train {kind}: the C layout has {c_bytes} bytes, "
             f"the mirror {want}, the plan {plan['smem_bytes']}")


def variant_score(t, dev, results):
    """Phase 22c: decode_score.cu's mean prior against its plain version
    at U=64, K=10, L=200 on the flagship's widths, from a later step with
    spread weights (a padded utterance, a row of zero weights): costs,
    weights, energies and weighted averages within 1e-4, a second call bit
    for bit, the time."""
    import torch
    from attention_lvcsr_torch.ops import decode_score as ds
    U, K, L, M, D, S, R, V, n = 64, 10, 200, 250, 500, 250, 250, 32, 100
    rng = np.random.RandomState(22)
    f = lambda *s, scale=1.0: t(rng.randn(*s) * scale)
    w = t(np.abs(rng.randn(U * K, L)) ** 4)
    w = w / w.sum(dim=1, keepdim=True)
    w[1] = 0.0
    frames = rng.randint(L // 2, L + 1, size=U)
    frames[0], frames[-1] = L, 0
    mask = t(np.arange(L)[None] < frames[:, None])
    tables = {"state_trans": f(S, M, scale=0.1), "handler": f(M),
              "v": f(M, scale=0.1), "merge_k": f(D, R, scale=0.05),
              "merge_b": f(R), "post_k": f(R, V, scale=0.1), "post_b": f(V),
              "conv_filters": f(1, 2 * n + 1, scale=0.3)}
    args = (f(U, L, M, scale=0.5), f(U, L, D), mask, w,
            torch.full((U * K,), 30, dtype=torch.int32, device=dev),
            f(U * K, S))
    kw = dict(beam=K, prior="window_around_mean", before=50.0, after=50.0)
    ds.launches.reset()
    got = ds.fused_decode_score(*args, tables, **kw)
    again = ds.fused_decode_score(*args, tables, **kw)
    if ds.launches.count != 2 or not all(
            torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"fused_decode_score mean prior: {ds.launches.count} launches "
             f"or a second call differs")
    ref = ds.fused_decode_score_reference(*args, tables, **kw)
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    if not err <= 1e-4:
        fail(f"fused_decode_score's mean prior disagrees with its plain "
             f"version: {err:.3e}")
    ms = graph_ms(lambda: ds.fused_decode_score(*args, tables, **kw), 50)
    plain_ms = cuda_ms(
        lambda: ds.fused_decode_score_reference(*args, tables, **kw), 10)
    row_ops = attention_step_ops(S, M, L, 2 * n + 1, D) \
        + readout_ops(D, R, V)
    results["fused_decode_score"]["mean"] = {
        "U": U, "K": K, "L": L, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms,
        **bound(nbytes(*args, tables, *got), U * K * row_ops),
        "library_ms": None}
    r = results["fused_decode_score"]["mean"]
    log(f"phase 22c fused_decode_score mean prior U={U} K={K} L={L}: max "
        f"abs err {err:.3e}, a second call bit for bit; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {r['bound_ms']:.4f} ms")


# the recipes' stages over their nets (batch 10, one epoch each, 2
# batches an epoch), as Configuration.ordered_stages merges them; the
# flagship's initialization and char_discount 3.0 (phase 19: the random
# models' hypotheses are empty below it)
VARIANT_MONITORING = {"validate_every_epochs": 1, "search_every_epochs": 1,
                      "search": {"beam_size": 10, "char_discount": 3.0,
                                 "stop_on": "optimistic_future_cost"}}


def variant_recipes():
    """{recipe: [(stage, config)]}: wsj_mean_maxout.yaml's ``pretraining``
    (the expanding window) and ``main`` (from ``pretraining_best_ll.zip``,
    the mean window), one stage each of wsj_bhd4.yaml and wsj_good.yaml."""
    drop = ("input_dims", "input_num_chars", "eos_label", "num_phonemes")
    net = lambda n: {k: v for k, v in n.items() if k not in drop}
    base = lambda n, training, regularization: {
        "net": net(n), "initialization": FLAGSHIP_INIT,
        "data": {"batch_size": 10}, "training": dict(training,
                                                     num_epochs=1),
        "regularization": regularization,
        "monitoring": copy.deepcopy(VARIANT_MONITORING)}
    nets = variant_nets()
    paper = dict(WSJ_PAPER["training"])
    pretraining = base(dict(nets["mean_maxout"],
                            prior=MEAN_MAXOUT_PRETRAINING),
                       paper, {"max_norm": 1.0})
    main = base(nets["mean_maxout"], dict(paper, restart_from="_best_ll"),
                {"max_norm": 1.0})
    return {
        "wsj_mean_maxout": [("pretraining", pretraining), ("main", main)],
        "wsj_bhd4": [("main", base(nets["bhd4"], MOMENTUM_ADADELTA,
                                   {"max_norm": 1.0}))],
        "wsj_good": [("main", base(nets["good"], MOMENTUM_ADADELTA, {}))]}


def variant_recipes_check(t, dev, rates):
    """Phase 22d: the recipes' stages through ``run_multistage`` on the
    kernels and on the plain route, 2 batches of 10 utterances of 300-500
    frames an epoch, validation and search (beam 10 at U=4, 4 of the
    training utterances) before each stage and after its epoch
    (``recipes_check``): the loop kernel for wsj_mean_maxout and
    wsj_bhd4, the module route for wsj_good, which has no post-merge
    layer.  Returns the kernel route's launches, per recipe."""
    batches = {10: stage_batches(t, dev, 2, 10, seed=22)}
    # validation on 4 of the training utterances: the steps lower their
    # cost, so that pretraining writes the _best_ll main restarts from
    valid = [{k: v[:4] for k, v in batches[10][0].items()}]
    return recipes_check(dev, rates, "22d", variant_recipes(), batches,
                         valid, {"wsj_mean_maxout": "beam_search_loop",
                                 "wsj_bhd4": "beam_search_loop",
                                 "wsj_good": None})


def first_step(stage):
    """A stage cut to its start and first step for the plain route:
    validation and search before the first batch, one batch, no
    validation or search after it."""
    stage = copy.deepcopy(stage)
    stage["training"]["num_batches"] = 1
    stage["monitoring"].update(validate_every_epochs=2,
                               search_every_epochs=2)
    return stage


def first_steps_agree(name, stages, loops, ref_loops, searches, firsts,
                      ref_searches, keys=("train_cost",
                                          "total_gradient_norm",
                                          "valid_sequence_total_cost")):
    """Each stage's kernel-route run (``loops``; its searches'
    hypotheses in ``searches``, the stage's first at ``firsts[number]``)
    against its ``first_step`` run on the plain route (``ref_loops``,
    ``ref_searches``): up to the plain run's one batch, the records of
    ``keys`` within 1e-4 relative and ``valid_per`` equal; every
    kernel-route train_cost finite; the plain searches' best hypotheses
    those of the stage's first searches on the kernels, beam costs within
    1e-4 relative.  Returns (hypotheses compared, non-empty among them,
    the largest relative cost difference)."""
    worst, nonempty, compared = 0.0, 0, 0
    firsts = list(firsts) + [len(searches)]
    for number, ((stage, _), lp, lr, got) in enumerate(
            zip(stages, loops, ref_loops, ref_searches)):
        horizon = lr.log.status["iterations_done"]
        for key in tuple(keys) + ("valid_per",):
            tg, g = lp.log.channel(key)
            tr, r = lr.log.channel(key)
            g = [v for i, v in zip(tg, g) if i <= horizon]
            tg = [i for i in tg if i <= horizon]
            if key == "valid_per":
                if tg != tr or g != r:
                    fail(f"{name} {stage}: valid_per {g} vs plain {r}")
                continue
            rel = np.abs(np.subtract(g, r)) / np.abs(r)
            if tg != tr or not tg or not (np.isfinite(g).all()
                                          and rel.max() <= 1e-4):
                fail(f"{name} {stage}: {key} {g} at {tg} vs plain {r} at "
                     f"{tr}")
        if not np.isfinite(lp.log.channel("train_cost")[1]).all():
            fail(f"{name} {stage}: train_cost "
                 f"{lp.log.channel('train_cost')[1]}")
        ours = searches[firsts[number]:firsts[number + 1]]
        if not got or len(ours) < len(got):
            fail(f"{name} {stage}: {len(ours)} searches vs {len(got)} on "
                 f"the plain route")
        for i, (mine, ref) in enumerate(zip(ours, got)):
            for u, ((h, c), (rh, rc)) in enumerate(zip(mine, ref)):
                if h != rh or (c is None) != (rc is None):
                    fail(f"{name} {stage}: search {i} utterance {u}: {h} "
                         f"({c}) vs the plain route's {rh} ({rc})")
                if c is not None:
                    worst = max(worst, abs(c - rc) / max(abs(rc), 1e-6))
                nonempty += bool(h)
                compared += 1
    if worst > 1e-4:
        fail(f"{name}: beam costs within {worst:.2e} of the plain route's")
    return compared, nonempty, worst


def recipes_check(dev, rates, phase, recipes, batches, valid, loop_routes):
    """The recipes' stages through ``run_multistage`` on the kernels over
    the in-memory ``batches`` ({batch size: batches} of an epoch),
    validation and search on ``valid`` before each stage and after its
    epoch, held against the plain route: each stage's start (validation
    and search) and first step from the checkpoint the kernel route's
    stage loaded (``first_step``).  Where both routes ran, train_cost,
    total_gradient_norm and validation costs within 1e-4 relative, the
    same valid_per and hypotheses, more than half of the compared
    hypotheses non-empty; every stage's costs finite; the route of every
    search (``loop_routes``: the
    loop kernel's instance that launches, ``beam_search_loop`` resident
    or ``beam_search_loop_ws``, or None for the module route); utt/s.
    Returns the kernel route's launches, per recipe."""
    from attention_lvcsr_torch.models import attention as attention_mod
    from attention_lvcsr_torch.models import cells as cells_mod
    from attention_lvcsr_torch.models import generator as generator_mod
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from attention_lvcsr_torch.ops import attention_energy as ae
    from attention_lvcsr_torch.ops import beam_loop as bl
    from attention_lvcsr_torch.ops import decoder_train as dt
    from attention_lvcsr_torch.ops import gru_scan as gs
    from attention_lvcsr_torch.ops import gru_train as gt
    from attention_lvcsr_torch.ops import outer_sum as osum
    from attention_lvcsr_torch.search import beam as beam_mod
    from attention_lvcsr_torch.train.checkpoint import save_checkpoint
    counters = {"gru_scan": gs.launches, "beam_search_loop": bl.launches,
                "beam_search_loop_ws": bl.launches_ws,
                "beam_attention_energies": ae.launches,
                "gru_scan_train_bidir": gt.launches_bidir,
                "decoder_scan_train": dt.launches, "outer_sum": osum.launches,
                "gru_scan_wide": gs.launches_wide,
                "gru_scan_train_bidir_wide": gt.launches_bidir_wide}
    plain = [(cells_mod, "gru_scan", gs.gru_scan_reference),
             (beam_mod, "beam_search_loop", bl.beam_search_loop_reference),
             (attention_mod, "beam_attention_energies",
              ae.beam_attention_energies_reference),
             (cells_mod, "gru_scan_train", gt.gru_scan_train_reference),
             (generator_mod, "decoder_scan_train",
              dt.decoder_scan_train_reference)]
    data = SmokeData()
    moved_all = {}
    for recipe, stages in recipes.items():
        t0 = time.perf_counter()
        tmp = tempfile.mkdtemp()
        try:
            start = os.path.join(tmp, "start.zip")
            net = dict(stages[0][1]["net"], input_dims={"recordings": 123},
                       eos_label=data.eos_label,
                       num_phonemes=data.num_labels)
            rec = SpeechRecognizer(net, init_config=FLAGSHIP_INIT,
                                   seed=1234, device=dev)
            readout = rec.net.generator.readout
            last = (readout.post_merge_0.bias if readout.num_post_merge
                    else readout.merge_bias)
            last.data[data.eos_label] += 1.5
            save_checkpoint(start, rec.param_path_dict())
            del rec
            for c in counters.values():
                c.reset()
            searches, started = [], []
            loops, marks = run_stages(dev, data, stages, batches, valid,
                                      os.path.join(tmp, "kernels"), start,
                                      searches, started=started)
            moved = counts(counters)
            spans = {"kernels": list(zip(marks, marks[1:]))}
            ref_loops, ref_searches, spans["plain"] = [], [], []
            for c in counters.values():
                c.reset()
            with swapped(plain):
                for number, (name, stage) in enumerate(stages):
                    got = []
                    lps, mks = run_stages(
                        dev, data, [(name, first_step(stage))], batches,
                        valid, os.path.join(tmp, f"plain{number}"),
                        started[number][1], got)
                    ref_loops += lps
                    ref_searches.append(got)
                    spans["plain"].append(tuple(mks))
            ref_moved = counts(counters)
        finally:
            shutil.rmtree(tmp)
        loop_route = loop_routes[recipe]
        used = {k for k, v in moved.items() if v}
        # the module route's energies: one filter's through the energy
        # kernel, more filters' in plain PyTorch (as JAX computes them)
        module = ({"beam_attention_energies"}
                  if (stages[0][1]["net"].get("conv_num_filters") or 1) == 1
                  else set())
        # each encoder layer's GRU instances by its width: the resident
        # ones, or the wide ones (forward above 448, backward above 384)
        dims = stages[0][1]["net"]["dims_bidir"]
        wide = lambda name, route: name + ("_wide" if route == "wide" else "")
        want = {wide("gru_scan", gs.route(d)) for d in dims} | {
            wide("gru_scan_train_bidir", pick(d)) for d in dims
            for pick in (gs.route, gt.backward_route)} | {
            "decoder_scan_train", "outer_sum"} | (
            {loop_route} if loop_route else module)
        if used != want or any(ref_moved.values()):
            fail(f"phase {phase} {recipe}: launches {moved} on the kernels, "
                 f"{ref_moved} on the plain route (expected {sorted(want)})")
        compared, nonempty, worst = first_steps_agree(
            f"phase {phase} {recipe}", stages, loops, ref_loops, searches,
            [first for first, _ in started], ref_searches)
        if nonempty <= compared // 2:
            fail(f"phase {phase} {recipe}: {nonempty} of {compared} "
                 f"compared hypotheses non-empty")
        for route, lps in (("kernels", loops), ("plain", ref_loops)):
            for (name, stage), lp, (s0, s1) in zip(stages, lps,
                                                   spans[route]):
                steps = lp.log.status["iterations_done"]
                B = stage["data"]["batch_size"]
                step_s = float(np.median(
                    lp.log.channel("time_train_this_batch")[1]))
                rates[f"{recipe}_{route}_{name}_utt_per_s"] = \
                    B * steps / (s1 - s0)
                rates[f"{recipe}_{route}_{name}_step_utt_per_s"] = \
                    B / step_s
                log(f"phase {phase} {recipe} {route} {name}: {s1 - s0:.2f} s "
                    f"for {steps} steps of B={B}, "
                    f"{B * steps / (s1 - s0):.2f} utt/s with validation "
                    f"and search, {B / step_s:.2f} utt/s in the steps")
        log(f"phase {phase} {recipe}: {len(searches)} searches on the "
            f"{loop_route or 'module route'}, "
            f"{sum(len(g) for g in ref_searches)} of them with the plain "
            f"route's hypotheses ({nonempty} of {compared} non-empty), beam "
            f"costs within {worst:.2e}; launches {moved}; "
            f"{time.perf_counter() - t0:.1f} s")
        moved_all[recipe] = moved
    return moved_all


def wsj_variants_phase(t, dev, results, rates):
    """Phase 22: the readout and attention variants of the WSJ recipes.
    Returns 22d's kernel-route launches, per recipe."""
    t0 = time.perf_counter()
    variant_loops(t, dev, results)
    variant_decoder(t, dev, results)
    variant_score(t, dev, results)
    log(f"phase 22a-c: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moved = variant_recipes_check(t, dev, rates)
    log(f"phase 22d: {time.perf_counter() - t0:.1f} s")
    return moved


def stacked_nets():
    """The nets of phase 23, the stacked decoders of wsj_jan_new.yaml's
    lineage over phase 22's ``mean_maxout`` (wsj_mean_maxout.yaml, whose
    ten filters, maxout:2 readout with the decoder states, 512-dim matcher
    and window around the mean they inherit):

    * ``wsj13v2``, wsj_jan_wsj13v2.yaml's: a 3x256 encoder subsampled 1,
      1, 2 and two 256-unit decoder layers;
    * ``wsj15v2``, wsj_jan_wsj15v2.yaml's: the 4x256 encoder subsampled 1,
      1, 2, 2 and two 512-unit layers (wsj_jan_wsj14v2.yaml has them over
      wsj13v2's encoder);
    * ``wsj_jan_debug``, wsj_jan_debug.yaml's: a 3x17 encoder subsampled
      1, 2, 2, two 19-unit layers, 27-tap filters."""
    mean_maxout = variant_nets()["mean_maxout"]
    return {
        "wsj13v2": dict(mean_maxout, dims_bidir=[256] * 3,
                        subsample=[1, 1, 2], dec_stack=2),
        "wsj15v2": dict(mean_maxout, dim_dec=512, dec_stack=2),
        "wsj_jan_debug": dict(mean_maxout, dims_bidir=[17] * 3,
                              subsample=[1, 2, 2], dim_dec=19, conv_n=13,
                              dec_stack=2)}


def stacked_loops(t, dev, results):
    """Phase 23a: beam_loop.cu's stacked instance against the plain loop
    (``loop_case``), beam 10, a 100-step cap, L=200 encoded frames: the
    main path's wsj13v2 at U=64 (400 frames) under the mean and the
    expanding prior, wsj15v2 (S=512, 800 frames), three and four 64-unit
    layers over wsj13v2's encoder, and wsj_jan_debug's odd widths (800
    frames), each at U=32."""
    nets = stacked_nets()
    wsj13v2 = nets["wsj13v2"]
    cases = (("stack2_mean", wsj13v2, 64, 400),
             ("stack2_expanding", dict(wsj13v2,
                                       prior=MEAN_MAXOUT_PRETRAINING),
              64, 400),
             ("stack2_S512", nets["wsj15v2"], 32, 800),
             ("stack3_S64", dict(wsj13v2, dim_dec=64, dec_stack=3), 32, 400),
             ("stack4_S64", dict(wsj13v2, dim_dec=64, dec_stack=4), 32, 400),
             ("stack2_debug", nets["wsj_jan_debug"], 32, 800))
    for name, net, U, frames in cases:
        rng = np.random.RandomState(23)
        feats = t(rng.randn(U, frames, 123))
        lengths = rng.randint(frames * 3 // 4, frames + 1, size=U)
        lengths[0] = frames
        fmask = t(np.arange(frames)[None] < lengths[:, None])
        loop_case(dev, results, "23a", name, net, feats, fmask, 10, 100,
                  U * 3 // 4)


def stacked_decoder(t, dev, results):
    """Phase 23b: decoder_train.cu's stacked forward and backward against
    the plain scan (``decoder_case``, ten filters, the mean prior, T=100
    labels): wsj13v2's decoder (two 256-unit layers, M=512, D=512, 201
    taps) at L=400 and B=10 and 32, wsj15v2's (two 512-unit layers) at
    L=200, B=10, and three and four 64-unit layers at L=100, M=128,
    D=128, B=10."""
    prior = variant_nets()["mean_maxout"]["prior"]
    for key, B, L, M, D, S, N in (
            ("stack2_B10", 10, 400, 512, 512, 256, 2),
            ("stack2_B32", 32, 400, 512, 512, 256, 2),
            ("stack2_S512_B10", 10, 200, 512, 512, 512, 2),
            ("stack3_S64_B10", 10, 100, 128, 128, 64, 3),
            ("stack4_S64_B10", 10, 100, 128, 128, 64, 4)):
        decoder_case(t, dev, results, "23b", key, prior, T=100, B=B, L=L,
                     M=M, D=D, S=S, N=N)


def stacked_recipe():
    """{recipe: [(stage, config)]}: wsj_jan_wsj13v2.yaml's ``pretraining``
    (the expanding window) and ``main`` (from ``pretraining_best_ll.zip``,
    the mean window) over the phase's net, with wsj_paper.yaml's adadelta
    (as phase 22d's wsj_mean_maxout): under the recipe's momentum-adadelta
    chain two steps of the random model need not lower the validation
    cost, and without a lower one no ``_best_ll`` is written."""
    stages = variant_recipes()["wsj_mean_maxout"]
    net = {k: v for k, v in stacked_nets()["wsj13v2"].items()
           if k not in ("input_dims", "input_num_chars", "eos_label",
                        "num_phonemes")}
    out = []
    for name, stage in stages:
        stage = copy.deepcopy(stage)
        stage["net"] = dict(net, prior=stage["net"]["prior"])
        out.append((name, stage))
    return {"wsj_jan_wsj13v2": out}


def stacked_recipe_check(t, dev, rates):
    """Phase 23c: wsj_jan_wsj13v2.yaml's two stages (``recipes_check``)
    over 2 batches of 10 utterances of 600-800 frames and 75-100 labels an
    epoch, validating and searching 4 of them cut to 400 frames, whose
    decodes fit a block (200,160 bytes: the resident instance; the
    800-frame decodes take the workspace instance, phase 25c).  Returns
    the kernel route's launches."""
    from attention_lvcsr_torch.search.beam import loop_route
    batches = {10: stage_batches(t, dev, 2, 10, seed=23, frames=800,
                                 labels=100)}
    valid = [{k: (v[:4, :400] if k.startswith("recordings") else v[:4])
              for k, v in batches[10][0].items()}]
    recipes = stacked_recipe()
    if not loop_route(recipes["wsj_jan_wsj13v2"][0][1]["net"], 10, 400):
        fail("phase 23c: the 400-frame search leaves the loop kernel")
    return recipes_check(dev, rates, "23c", recipes, batches, valid,
                         {"wsj_jan_wsj13v2": "beam_search_loop"})[
        "wsj_jan_wsj13v2"]


def stacked_steps(t, dev, rates):
    """Phase 23d: two training steps of wsj_jan_wsj15v2.yaml and of
    wsj_jan_debug.yaml on the kernel route (B=10, 800 frames, 100
    labels): finite costs and gradient norms, the training kernels'
    launches.  Returns them, per recipe."""
    batches = train_batches(t, dev, 2, B=10, T=800, TL=100, seed=23)
    moved_all = {}
    for recipe in ("wsj15v2", "wsj_jan_debug"):
        net = stacked_nets()[recipe]
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            _, _, moved, mon = train_steps(dev, net, batches, 2,
                                           os.path.join(tmp, "m.zip"))
        secs = time.perf_counter() - t0
        if moved["decoder_scan_train"] != 4 or not moved["outer_sum"] \
                or not np.isfinite(mon["train_cost"]).all() \
                or not np.isfinite(mon["total_gradient_norm"]).all():
            fail(f"phase 23d {recipe}: launches {moved}, train_cost "
                 f"{mon['train_cost']}, norms {mon['total_gradient_norm']}")
        rates[f"{recipe}_step_utt_per_s"] = 10 / float(
            np.median(mon["time_train_this_batch"]))
        log(f"phase 23d {recipe}: 2 steps of B=10, 800 frames on the "
            f"kernels in {secs:.1f} s, train_cost "
            f"{mon['train_cost'].tolist()}, gradient norms "
            f"{mon['total_gradient_norm'].tolist()}; launches {moved}")
        moved_all[recipe] = {k: v for k, v in moved.items() if v}
    return moved_all


def stacked_phase(t, dev, results, rates):
    """Phase 23: stacked GRU decoders.  Returns 23c's and 23d's kernel
    launches, per recipe."""
    t0 = time.perf_counter()
    stacked_loops(t, dev, results)
    stacked_decoder(t, dev, results)
    log(f"phase 23a-b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moved = {"wsj_jan_wsj13v2": stacked_recipe_check(t, dev, rates)}
    log(f"phase 23c: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moved.update(stacked_steps(t, dev, rates))
    log(f"phase 23d: {time.perf_counter() - t0:.1f} s")
    return moved


def pyramide_net():
    """exp/wsj/configs/wsj_pyramide.yaml's net over wsj_paper.yaml's (the
    flagship's, ``FLAGSHIP_NET``): a 250, 500, 1000-unit BiGRU encoder
    subsampled 1, 2, 2 (an 800-frame utterance's layers run over 800, 800
    and 400 frames, 200 attended: a stride applies to a layer's output),
    a relu post-merge layer of 1000, the window around the median +-200
    (``main``; ``pretraining`` the expanding ``PYRAMIDE_PRETRAINING``)."""
    from __graft_entry__ import FLAGSHIP_NET
    return dict(FLAGSHIP_NET, dims_bidir=[250, 500, 1000],
                subsample=[1, 2, 2], post_merge_dims=[1000],
                post_merge_activation="relu",
                prior={"type": "window_around_median", "before": 200,
                       "after": 200})


PYRAMIDE_PRETRAINING = {"type": "expanding", "initial_begin": 0,
                        "initial_end": 40, "min_speed": 1.2,
                        "max_speed": 2.1}
# the main path's wide layers: (D, frames of an 800-frame utterance)
PYRAMIDE_WIDE = ((500, 800), (1000, 400))


def wide_scan_check(t, dev, results):
    """Phase 24a: gru_scan.cu's wide instance against the plain scan at the
    serving batch U=64, both directions, a ragged mask, the recipe's wide
    layers (D=500 over 800 frames, D=1000 over 400): states within 1e-5,
    a second call bit for bit, the C layout against the mirror at both
    cluster sizes, the cluster the launcher takes, the times and bounds."""
    import ctypes
    import torch
    from attention_lvcsr_torch import _build
    from attention_lvcsr_torch.ops import gru_scan as gs
    lib = _build.load().lib
    lib.gru_scan_wide_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    U = 64
    cases = {}
    for D, T in PYRAMIDE_WIDE:
        for size in gs.CLUSTERS:
            mirror = gs.wide_layout(D, size)["smem_bytes"]
            if lib.gru_scan_wide_smem_bytes(D, size) != mirror:
                fail(f"gru_scan wide: the C layout of {size}-block clusters "
                     f"at D={D} has {lib.gru_scan_wide_smem_bytes(D, size)} "
                     f"bytes, the mirror {mirror}")
        rng = np.random.RandomState(24 + D)
        lengths = rng.randint(T * 3 // 8, T + 1, size=U)
        lengths[0] = T
        proj = t(rng.randn(T, U, 6 * D) * 0.5)
        mask = t((np.arange(T)[:, None] < lengths[None, :]).astype(
            np.float32))
        weights = [(t(rng.randn(U, D) * 0.1),
                    t(rng.randn(D, D) / np.sqrt(D)),
                    t(rng.randn(D, 2 * D) / np.sqrt(D))) for _ in range(2)]
        args = (proj, mask, *weights)
        plan = gs.launch_plan(D, U, 2, dev)
        gs.launches_wide.reset()
        got = gs.gru_scan(*args)
        ref = gs.gru_scan_reference(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if gs.launches_wide.count != 1 or not err <= 1e-5:
            fail(f"gru_scan wide D={D}: max abs err {err}, "
                 f"{gs.launches_wide.count} wide launches")
        if not torch.equal(got, gs.gru_scan(*args)):
            fail(f"gru_scan wide D={D}: a second call gave other bits")
        layout = gs.wide_layout(D, plan["cluster"])
        smem, ring = layout["smem_bytes"], layout["ring"]
        case = {"max_abs_err": err, "ms": cuda_ms(lambda: gs.gru_scan(*args),
                                                  3),
                "plain_ms": cuda_ms(lambda: gs.gru_scan_reference(*args), 1),
                **bound(nbytes(proj, mask, *[w for d in weights for w in d],
                               got), 2 * T * U * gru_step_ops(D)),
                "library_ms": None, "T": T, "B": U,
                "cluster": plan["cluster"], "clusters": plan["clusters"],
                "active": plan["active"], "smem_bytes": smem,
                "ring_slots": ring["slots"],
                "resident_tiles": [ring["res0"], ring["res1"]]}
        cases[f"D{D}"] = case
        log(f"phase 24a gru_scan wide T={T} U={U} D={D}, both directions: "
            f"max abs err {err:.3e}, a second call bit for bit; "
            f"{plan['clusters']} clusters of {plan['cluster']} blocks (the "
            f"card holds {plan['active'][16]} of 16 and {plan['active'][8]} "
            f"of 8), {smem} bytes a block, a ring of {ring['slots']} slots, "
            f"{ring['res0']} of {-(-layout['Dp'] // layout['kt_g'])} gate "
            f"and {ring['res1']} of {-(-layout['Dp'] // layout['kt_c'])} "
            f"candidate tiles resident; kernel {case['ms']:.3f} ms, plain "
            f"{case['plain_ms']:.3f} ms, bound {case['bound_ms']:.3f} ms")
    # the row: the widest layer, the other beside it
    results["gru_scan_wide"] = dict(
        cases["D1000"], D500=cases["D500"],
        max_abs_err=max(c["max_abs_err"] for c in cases.values()))


def wide_train_check(t, dev, results):
    """Phase 24b: gru_scan_train_bidir through the wide instances (the
    forward with its residuals, the backward, outer_sum) against autograd
    through the plain scan at B=32, the recipe's wide layers, phase 11's
    tolerances (``gru_train_case``), the C layouts against the mirror;
    and one direction at D=1000."""
    import ctypes
    from attention_lvcsr_torch import _build
    from attention_lvcsr_torch.ops import gru_train as gt
    lib = _build.load().lib
    lib.gru_train_wide_smem_bytes.argtypes = [ctypes.c_int]
    cases = {}
    B = 32
    for D, T in PYRAMIDE_WIDE:
        if lib.gru_train_wide_smem_bytes(D) != \
                gt.bwd_wide_layout(D)["smem_bytes"]:
            fail(f"gru_train wide: the C layout at D={D} has "
                 f"{lib.gru_train_wide_smem_bytes(D)} bytes, the mirror "
                 f"{gt.bwd_wide_layout(D)['smem_bytes']}")
        rng = np.random.RandomState(240 + D)
        lengths = rng.randint(T * 3 // 8, T + 1, size=B)
        lengths[0] = T
        mask = t((np.arange(T)[:, None] < lengths[None, :]).astype(
            np.float32))
        gt.launches_bidir_wide.reset()
        case = gru_train_case(t, rng, mask, D, 2, "24b",
                              "gru_scan_train_bidir wide")
        if not gt.launches_bidir_wide.count:
            fail(f"gru_scan_train wide D={D}: no wide launch")
        layout = gt.bwd_wide_layout(D)
        ring = layout["ring"]
        cases[f"D{D}"] = dict(
            case, T=T, B=B, smem_bytes=layout["smem_bytes"],
            ring_slots=ring["slots"],
            resident_tiles=[ring["res0"], ring["res1"]])
        log(f"phase 24b gru_train wide D={D}: {layout['smem_bytes']} bytes "
            f"a block, a ring of {ring['slots']} slots, {ring['res0']} of "
            f"{-(-layout['Dp'] // layout['kt'])} reset-path and "
            f"{ring['res1']} of {-(-2 * layout['Dp'] // layout['kt'])} "
            f"gate-path tiles resident")
    # one direction (gru_scan_train :291's route; no recipe runs it)
    D, T = PYRAMIDE_WIDE[-1]
    rng = np.random.RandomState(241)
    mask = t((np.arange(T)[:, None] < rng.randint(
        T * 3 // 8, T + 1, size=B)[None, :]).astype(np.float32))
    gt.launches_wide.reset()
    one = gru_train_case(t, rng, mask, D, 1, "24b", "gru_scan_train wide")
    if not gt.launches_wide.count:
        fail(f"gru_scan_train wide D={D}, one direction: no wide launch")
    results["gru_scan_train_bidir_wide"] = dict(
        cases["D1000"], D500=cases["D500"], one_direction=dict(one, T=T, B=B),
        max_abs_err=max(c["max_abs_err"] for c in cases.values()))


def pyramide_decoder(t, dev, results):
    """Phase 24b, last: decoder_train.cu at the recipe's attention (the
    1000-unit layer's both directions: D=2000 attended, L=200, M=250,
    S=250, one 201-tap filter, the window around the median +-200) and
    T=100 labels, B=10 and 32, against the plain scan (``decoder_case``):
    its first run at D=2000."""
    prior = pyramide_net()["prior"]
    for key, B in (("pyramide_B10", 10), ("pyramide_B32", 32)):
        decoder_case(t, dev, results, "24b", key, prior, T=100, B=B, L=200,
                     M=250, D=2000, S=250, nf=1)


def pyramide_batches(t, dev, n, B, seed):
    """``n`` batches of ``B`` utterances of 600-800 frames and 75-100
    labels (row 0 the longest in both), each label row ending with the
    EOS label as the data streams end them."""
    import torch
    rng = np.random.RandomState(seed)
    T, TL, eos = 800, 100, CHAR_MAP["<eol>"]
    batches = []
    for _ in range(n):
        frames, labels = rng.randint(600, T + 1, size=B), \
            rng.randint(75, TL + 1, size=B)
        frames[0], labels[0] = T, TL
        symbols = rng.randint(0, eos, size=(B, TL))
        symbols[np.arange(B), labels - 1] = eos
        batches.append({
            "recordings": t(rng.randn(B, T, 123)),
            "recordings_mask": t(np.arange(T)[None] < frames[:, None]),
            "labels": torch.tensor(symbols, device=dev),
            "labels_mask": t(np.arange(TL)[None] < labels[:, None])})
    return batches


def pyramide_recipe_check(t, dev, rates, batches):
    """Phase 24c: wsj_pyramide.yaml's ``pretraining`` (the expanding
    window) and ``main`` (from ``pretraining_best_ll.zip``, the window
    around the median) at the recipe's widths through ``recipes_check`` on
    the kernels and on the plain route over ``batches`` ({10: an epoch's
    batches}), validation and search (beam 10, char_discount 3.0) of 4 of
    the utterances at full length, which take the loop kernel's workspace
    instance (its resident block would need 282,880 bytes).  Returns the
    kernel route's launches."""
    from attention_lvcsr_torch.search.beam import loop_route
    net = {k: v for k, v in pyramide_net().items()
           if k not in ("input_dims", "input_num_chars", "eos_label",
                        "num_phonemes")}
    stage = lambda prior, training: {
        "net": dict(net, prior=prior), "initialization": FLAGSHIP_INIT,
        "data": {"batch_size": 10},
        "training": dict(training, num_epochs=1),
        "regularization": {"max_norm": 1.0},
        "monitoring": copy.deepcopy(VARIANT_MONITORING)}
    paper = dict(WSJ_PAPER["training"])
    recipes = {"wsj_pyramide": [
        ("pretraining", stage(PYRAMIDE_PRETRAINING, paper)),
        ("main", stage(net["prior"], dict(paper, restart_from="_best_ll")))]}
    # validation on 4 of the training utterances: the steps lower their
    # cost, so that pretraining writes the _best_ll main restarts from
    valid = [{k: v[:4] for k, v in batches[10][0].items()}]
    if not loop_route(pyramide_net(), 10, 800):
        fail("phase 24c: the 800-frame decode leaves the loop kernel")
    return recipes_check(dev, rates, "24c", recipes, batches, valid,
                         {"wsj_pyramide": "beam_search_loop_ws"})[
        "wsj_pyramide"]


def pyramide_serve(t, dev, rates):
    """Phase 24d: the recipe's model (random weights from seed 1234, the
    EOS logit raised by 6) decoding as the server runs it
    (``Transcriber.transcribe_batch`` with the stage's
    ``monitoring.search`` options, as ``serve.py::build_server`` takes
    them): 16 utterances of 600-800 frames at once, beam 10,
    char_discount 3.0, the optimistic stop, on the kernels and on the
    plain route: the same hypotheses, costs within 1e-4 relative, more
    than half of them with a symbol besides EOS (the raised EOS logit
    lets the random model's hypotheses finish within the 266-step cap);
    the launches (the loop kernel's workspace instance) and utt/s.
    Returns the kernel route's launches."""
    import torch
    from attention_lvcsr_torch.models import cells as cells_mod
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from attention_lvcsr_torch.ops import attention_energy as ae
    from attention_lvcsr_torch.ops import beam_loop as bl
    from attention_lvcsr_torch.ops import gru_scan as gs
    from attention_lvcsr_torch.search import beam as beam_mod
    from attention_lvcsr_torch.serve import Transcriber
    rec = SpeechRecognizer(pyramide_net(), init_config=FLAGSHIP_INIT,
                           seed=1234, device=dev)
    eos = CHAR_MAP["<eol>"]
    rec.net.generator.readout.post_merge_0.bias.data[eos] += 6.0
    # the search options as serve.py::build_server takes them from the
    # stage's monitoring.search
    search = VARIANT_MONITORING["search"]
    transcriber = Transcriber(rec, char_map=CHAR_MAP,
                              beam_size=search["beam_size"], search_kwargs={
                                  "char_discount": search["char_discount"],
                                  "round_to_inf": search.get("round_to_inf",
                                                             1e9),
                                  "stop_on": search["stop_on"]})
    rng = np.random.RandomState(241)
    feats = [rng.randn(int(n), 123).astype(np.float32)
             for n in rng.randint(600, 801, size=16)]
    U = len(feats)
    counters = {"gru_scan": gs.launches, "gru_scan_wide": gs.launches_wide,
                "beam_attention_energies": ae.launches,
                "beam_search_loop": bl.launches,
                "beam_search_loop_ws": bl.launches_ws}
    plain = [(cells_mod, "gru_scan", gs.gru_scan_reference),
             (beam_mod, "beam_search_loop", bl.beam_search_loop_reference)]
    answers, moved = {}, {}
    for route in ("kernels", "plain"):
        for c in counters.values():
            c.reset()
        with swapped(plain if route == "plain" else []):
            t0 = time.perf_counter()
            answers[route] = transcriber.transcribe_batch(feats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        moved[route] = counts(counters)
        rates[f"wsj_pyramide_serve_{route}_utt_per_s"] = U / wall
    if moved["kernels"]["beam_search_loop"] \
            or moved["kernels"]["beam_attention_energies"] or not all(
                moved["kernels"][k] for k in ("gru_scan", "gru_scan_wide",
                                              "beam_search_loop_ws")) \
            or any(moved["plain"].values()):
        fail(f"phase 24d: launches {moved['kernels']} on the kernels, "
             f"{moved['plain']} on the plain route")
    worst = 0.0
    for u, (got, ref) in enumerate(zip(answers["kernels"],
                                       answers["plain"])):
        costs = (got["cost"], ref["cost"])
        if got["labels"] != ref["labels"] or (None in costs) and \
                costs[0] != costs[1]:
            fail(f"phase 24d: utterance {u}: {got} vs the plain route's "
                 f"{ref}")
        if None not in costs:
            worst = max(worst, abs(costs[0] - costs[1])
                        / max(abs(costs[1]), 1e-6))
    found = sum(a["cost"] is not None and any(x != eos for x in a["labels"])
                for a in answers["kernels"])
    if worst > 1e-4 or found <= U // 2:
        fail(f"phase 24d: costs within {worst:.2e}, {found} of {U} "
             f"hypotheses non-empty")
    log(f"phase 24d serve decode U={U}, 600-800 frames, beam 10, "
        f"char_discount 3.0: the plain route's hypotheses ({found} of {U} "
        f"with a symbol besides EOS), costs within {worst:.2e}; "
        f"{rates['wsj_pyramide_serve_kernels_utt_per_s']:.2f} utt/s on the "
        f"kernels, {rates['wsj_pyramide_serve_plain_utt_per_s']:.2f} plain; "
        f"launches {moved['kernels']}")
    return {k: v for k, v in moved["kernels"].items() if v}


def resident_gru_bits(t, dev):
    """The resident GRU routes at the flagship's D=250, with the cluster
    sizes their launch plans take on an H100 forced (8 blocks for the
    decode's B=64, 16 for the training forward's B=32): the sha256 of
    gru_scan's states (T=800, B=64, both directions, ragged mask) and of
    gru_scan_train_bidir's states and every gradient (B=32), and the
    times of gru_scan and of the training scan's forward + backward.
    Returns ({output: sha256}, {name: ms})."""
    import hashlib
    import torch
    from attention_lvcsr_torch.ops import gru_scan as gs
    from attention_lvcsr_torch.ops import gru_train as gt
    digest = lambda x: hashlib.sha256(
        x.detach().contiguous().cpu().numpy().tobytes()).hexdigest()
    rng = np.random.RandomState(242)
    T, D = 800, 250
    hashes, times = {}, {}
    saved = gs.max_active_clusters
    try:
        for B, cluster in ((64, 8), (32, 16)):
            gs.max_active_clusters = lambda D, device, c=cluster: {
                size: 16 if size == c else 0 for size in gs.CLUSTERS}
            lengths = rng.randint(300, T + 1, size=B)
            lengths[0] = T
            mask = t((np.arange(T)[:, None] < lengths[None, :]).astype(
                np.float32))
            proj = t(rng.randn(T, B, 6 * D) * 0.5)
            dirs = [(t(rng.randn(B, D) * 0.1),
                     t(rng.randn(D, D) / np.sqrt(D)),
                     t(rng.randn(D, 2 * D) / np.sqrt(D))) for _ in range(2)]
            if B == 64:
                hashes["gru_scan"] = digest(gs.gru_scan(proj, mask, *dirs))
                times["gru_scan"] = cuda_ms(
                    lambda: gs.gru_scan(proj, mask, *dirs), 5)
                continue
            cot = [t(rng.randn(T, B, 2 * D))]
            leaves = [proj] + [w for d in dirs for w in d]
            fn = lambda p, *w: gt.gru_scan_train(p, mask, tuple(w[:3]),
                                                 tuple(w[3:]))
            (out,), grads = grads_of(fn, leaves, cot)
            hashes["gru_scan_train_bidir states"] = digest(out)
            for name, g in zip(("dproj", "dh0[0]", "dW_ss[0]", "dW_sg[0]",
                                "dh0[1]", "dW_ss[1]", "dW_sg[1]"), grads):
                hashes[f"gru_scan_train_bidir {name}"] = digest(g)
            times["gru_scan_train_bidir fwd"] = cuda_ms(
                lambda: fn(*leaves), 5)
            times["gru_scan_train_bidir bwd"] = backward_ms(fn, leaves, cot,
                                                            5)
    finally:
        gs.max_active_clusters = saved
    return hashes, times


def wide_gru_bits(t, dev):
    """The wide GRU instances at wsj_pyramide.yaml's wide layers
    (``PYRAMIDE_WIDE``), with the cluster sizes their launch plans take on
    an H100 forced (8 blocks for the decode's U=64 at D=500, 16 at D=1000
    and for the training's B=32): the sha256 of gru_scan's states (U=64,
    both directions, ragged mask) and of gru_scan_train_bidir's states and
    every gradient (B=32), and the times of gru_scan and of the backward
    kernel alone.  Returns ({output: sha256}, {name: ms})."""
    import hashlib
    import torch
    from attention_lvcsr_torch.ops import gru_scan as gs
    from attention_lvcsr_torch.ops import gru_train as gt
    digest = lambda x: hashlib.sha256(
        x.detach().contiguous().cpu().numpy().tobytes()).hexdigest()
    rng = np.random.RandomState(243)
    hashes, times = {}, {}
    saved = gs.max_active_clusters
    try:
        for D, T in PYRAMIDE_WIDE:
            for B in (64, 32):
                cluster = 8 if (D, B) == (500, 64) else 16
                gs.max_active_clusters = lambda D, device, c=cluster: {
                    size: 16 if size == c else 0 for size in gs.CLUSTERS}
                lengths = rng.randint(T * 3 // 8, T + 1, size=B)
                lengths[0] = T
                mask = t((np.arange(T)[:, None] < lengths[None, :]).astype(
                    np.float32))
                proj = t(rng.randn(T, B, 6 * D) * 0.5)
                dirs = [(t(rng.randn(B, D) * 0.1),
                         t(rng.randn(D, D) / np.sqrt(D)),
                         t(rng.randn(D, 2 * D) / np.sqrt(D)))
                        for _ in range(2)]
                if B == 64:
                    key = f"gru_scan D{D}"
                    hashes[key] = digest(gs.gru_scan(proj, mask, *dirs))
                    times[key] = cuda_ms(
                        lambda: gs.gru_scan(proj, mask, *dirs), 3)
                    continue
                cot = [t(rng.randn(T, B, 2 * D))]
                leaves = [proj] + [w for d in dirs for w in d]
                fn = lambda p, *w: gt.gru_scan_train(p, mask, tuple(w[:3]),
                                                     tuple(w[3:]))
                (out,), grads = grads_of(fn, leaves, cot)
                key = f"gru_scan_train_bidir D{D}"
                hashes[f"{key} states"] = digest(out)
                for name, g in zip(("dproj", "dh0[0]", "dW_ss[0]",
                                    "dW_sg[0]", "dh0[1]", "dW_ss[1]",
                                    "dW_sg[1]"), grads):
                    hashes[f"{key} {name}"] = digest(g)
                times[f"{key} bwd kernel"] = gru_backward_kernel_ms(
                    proj, mask, dirs, cot[0], 3)
    finally:
        gs.max_active_clusters = saved
    return hashes, times


# resident_gru_bits' hashes of the tree before the wide instances (commit
# d77f44a, tools/torch_gru_bits.py on an H100): the resident kernels kept
# their code, so their outputs keep these bits
RESIDENT_BITS = {
    "gru_scan":
        "74b74651ad2de4b820db904d4e705428146dd4d56377ffa41ae106c13c87e7e4",
    "gru_scan_train_bidir states":
        "a4e2dba7c4953bf477c6e7e0d832e6daa59d24f48d0c027e94014fd661f6d5d3",
    "gru_scan_train_bidir dproj":
        "d32e7f7c06dba89788e4e2a6a4389dc378cd732d2d52914210fa8a69afacc8a3",
    "gru_scan_train_bidir dh0[0]":
        "ce953b3103d79b27bd017ea06c416423d6046b539c5458616931eab6a657cf80",
    "gru_scan_train_bidir dW_ss[0]":
        "cab1a2c69ccd5ba58bba66cc715f181caa3a8797a1e3bac2acbfcd91c8193848",
    "gru_scan_train_bidir dW_sg[0]":
        "2fc6ed17b1bc88359c94b2d893387997af4357aff4b3f958932407fea3fac163",
    "gru_scan_train_bidir dh0[1]":
        "f72654039e39dd19100703c60540bdb71005735157301c1bf3a8a356ce013568",
    "gru_scan_train_bidir dW_ss[1]":
        "321ac5225a3370aabf40d032d3b623c3aa41ee27bc80870a902c1849147c329f",
    "gru_scan_train_bidir dW_sg[1]":
        "f9d880ca511453ac7f5163339a7e1e37e76fa441f347ac041424dcfb93b5c124"}


def resident_check(t, dev, rates):
    """Phase 24e: the resident routes of gru_scan.cu and gru_train.cu at
    D=250 (``resident_gru_bits``) hash to the bits of the tree before the
    wide instances; their times beside it."""
    hashes, times = resident_gru_bits(t, dev)
    differ = sorted(k for k, v in hashes.items() if RESIDENT_BITS.get(k) != v)
    if differ:
        fail(f"phase 24e: the resident routes changed their bits: {differ}")
    rates.update({f"resident {k} ms": v for k, v in times.items()})
    log(f"phase 24e resident routes at D=250: {len(hashes)} outputs hash to "
        f"the earlier tree's bits; " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in times.items()))


# wide_gru_bits' hashes of the tree before the redesigned wide instances
# (commit 2ef63d9, tools/torch_gru_bits.py --wide on an H100): the
# redesign keeps every output's k-ordered sums, so its outputs keep these
# bits
WIDE_BITS = {
    "gru_scan D500":
        "d65462bb22fa4f1795cda5f2cb8860052ca6636a0bef8fd77cc911971d766a29",
    "gru_scan_train_bidir D500 states":
        "71fdccaedef38e4ba21023956f9c91356961561fe4447bb8e8f0887f5a3377de",
    "gru_scan_train_bidir D500 dproj":
        "e8b637f428646dd9d4333fdec307892bda3b35d114deda73c3c494a0ae7209fe",
    "gru_scan_train_bidir D500 dh0[0]":
        "b136fcd7e1ade097d0d4edbb081e12fb9c6371dcd037d7c92d653bb99f22fac7",
    "gru_scan_train_bidir D500 dW_ss[0]":
        "6b5ed56d28652d84ceacffa28d5900eb477d785971d1b9984aa99c2e43ee51f5",
    "gru_scan_train_bidir D500 dW_sg[0]":
        "4c35c19dabea35eaeef01f1b50349a7971bd13f0d6a19ae1e6ca92132f9c39a9",
    "gru_scan_train_bidir D500 dh0[1]":
        "26e69e0579f9170dc790515f4c4755d5e5c61d7c6e255808a1930482f20be68c",
    "gru_scan_train_bidir D500 dW_ss[1]":
        "b1f8a19cbe0cd867a53b448f60649a88feb94a41277577324a1d77864de9360c",
    "gru_scan_train_bidir D500 dW_sg[1]":
        "b976f24c701bf8a25b60beb5c3ebd5a5000044625066521bd81baf46cc59a53d",
    "gru_scan D1000":
        "fdf104f20f9ce722bc40eb881e1052507bc054a0ff4c78e7ed11648af01ea732",
    "gru_scan_train_bidir D1000 states":
        "0b507fdcc11d56d4dc7178b9dc7deafd0d907d0e4d7bafdac3f0055ec4be663e",
    "gru_scan_train_bidir D1000 dproj":
        "b57413edc185fa9a23eb74eee9a553ca057b6ba846132d8f55973cc2e3a709c2",
    "gru_scan_train_bidir D1000 dh0[0]":
        "bd790fed69c20087df4b1f9ce2a7643c632bf531c10e678c342669ce54be6e5e",
    "gru_scan_train_bidir D1000 dW_ss[0]":
        "e279e4359a3723129df73ab21a6e0cc0772803524e1cbd8cb0195daa1b185612",
    "gru_scan_train_bidir D1000 dW_sg[0]":
        "b9ceeeb0b045f03d9a569353725fccc54a813e5ab5d15ef92a69e0cfc02b9170",
    "gru_scan_train_bidir D1000 dh0[1]":
        "555dacef312cdceebb5c294eeb5baf2bb1e627baa4a4f703c34332461d9f8f81",
    "gru_scan_train_bidir D1000 dW_ss[1]":
        "3d37651462b081fbbc85bc5505a4d7f9e7bd5b9225c258bebfcabdfa991b8f3e",
    "gru_scan_train_bidir D1000 dW_sg[1]":
        "7a8bd6fef1385106e5e50c9431647da0ef950dabfc099a4dc06ec40cd223cd50"}


def wide_bits_check(t, dev, rates):
    """Phase 24f: the wide instances at wsj_pyramide.yaml's wide layers
    (``wide_gru_bits``) hash to the bits of the tree before their
    redesign; their times beside it."""
    hashes, times = wide_gru_bits(t, dev)
    differ = sorted(k for k, v in hashes.items() if WIDE_BITS.get(k) != v)
    if differ or len(hashes) != len(WIDE_BITS):
        fail(f"phase 24f: the wide instances changed their bits: {differ}")
    rates.update({f"wide {k} ms": v for k, v in times.items()})
    log(f"phase 24f wide instances: {len(hashes)} outputs hash to the "
        f"earlier tree's bits; " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in times.items()))


def pyramide_phase(t, dev, results, rates):
    """Phase 24: the wide GRU instances and wsj_pyramide.yaml end to end.
    Returns 24c's and 24d's kernel-route launches."""
    t0 = time.perf_counter()
    wide_scan_check(t, dev, results)
    wide_train_check(t, dev, results)
    pyramide_decoder(t, dev, results)
    log(f"phase 24a-b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    batches = {10: pyramide_batches(t, dev, 2, 10, seed=24)}
    moved = {"wsj_pyramide train": pyramide_recipe_check(t, dev, rates,
                                                         batches)}
    log(f"phase 24c: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moved["wsj_pyramide serve"] = pyramide_serve(t, dev, rates)
    log(f"phase 24d: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    resident_check(t, dev, rates)
    log(f"phase 24e: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    wide_bits_check(t, dev, rates)
    log(f"phase 24f: {time.perf_counter() - t0:.1f} s")
    return moved


# ---- phase 25: the loop kernel's workspace instances -------------------------

def wide_beam_loops(t, dev, results):
    """Phase 25a: the workspace instance against the plain loop
    (``loop_case``) on the flagship's tables, 800 frames, a 100-step cap:
    U=64 at beam 18, 64 and 200, U=8 at beam 512, and odd widths (S=251,
    M=253, R=249, D=502) at beam 40, U=16."""
    from __graft_entry__ import FLAGSHIP_NET
    U, frames = 64, 800
    rng = np.random.RandomState(25)
    feats = t(rng.randn(U, frames, 123))
    lengths = rng.randint(600, frames + 1, size=U)
    lengths[0] = frames
    fmask = t(np.arange(frames)[None] < lengths[:, None])
    odd = dict(FLAGSHIP_NET, dim_dec=251, dim_matcher=253,
               post_merge_dims=[249], dims_bidir=[251] * 4)
    for name, net, K, n in (("beam18", FLAGSHIP_NET, 18, 64),
                            ("beam64", FLAGSHIP_NET, 64, 64),
                            ("beam200", FLAGSHIP_NET, 200, 64),
                            ("beam512_U8", FLAGSHIP_NET, 512, 8),
                            ("odd_beam40_U16", odd, 40, 16)):
        loop_case(dev, results, "25a", name, net, feats[:n], fmask[:n], K,
                  frames // 8, n * 3 // 4, repeats=1 if K >= 200 else 3)
    # the kernels line's row: decode.sh's beam 200, the other cases beside
    ws = results["beam_search_loop_ws"]
    ws.update({k: v for k, v in ws["beam200"].items()
               if k not in ("U", "K", "L")},
              max_abs_err=max(c["max_abs_err"] for c in ws.values()
                              if isinstance(c, dict) and "max_abs_err" in c))


def workspace_bits(t, dev, results):
    """Phase 25b: at beam 10, where both instances fit, the workspace
    instance gives the resident instance's bits on phase 3's main path
    (the flagship's tables, U=64, 800 frames, a 100-step cap); both
    timed, the workspace instance's C layout against the mirror."""
    import torch
    from __graft_entry__ import FLAGSHIP_NET
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from attention_lvcsr_torch.ops import beam_loop as bl
    U, frames = 64, 800
    rec = SpeechRecognizer(dict(FLAGSHIP_NET, max_decoded_length_scale=8.0),
                           init_config=FLAGSHIP_INIT, seed=1234, device=dev)
    feats = t(np.random.RandomState(1).randn(U, frames, 123))
    fmask = torch.ones(U, frames, device=dev)
    with torch.inference_mode():
        d = rec.net.decode_loop(feats, fmask)
        tables = rec.net.decode_loop_tables()
    prior = rec.net.generator.attention.prior_config()
    kw = dict(beam=10, max_len=frames // 8, eol=rec.eos_label,
              ignore_first_eol=rec.data_prepend_eos, prior=prior["type"],
              before=float(prior["before"]), after=float(prior["after"]))
    args = (d["pre"], d["attended"], d["attended_mask"], tables)
    outs, ms = {}, {}
    for instance in ("resident", "workspace"):
        bl.launches.reset()
        bl.launches_ws.reset()
        outs[instance] = bl.beam_search_loop(*args, instance=instance, **kw)
        torch.cuda.synchronize()
        if (bl.launches.count, bl.launches_ws.count) != (
                (1, 0) if instance == "resident" else (0, 1)):
            fail(f"phase 25b: the {instance} instance did not launch")
        ms[instance] = cuda_ms(lambda: bl.beam_search_loop(
            *args, instance=instance, **kw), 3)
    if not all(torch.equal(a, b) for a, b in zip(outs["resident"],
                                                 outs["workspace"])):
        fail("phase 25b: the workspace instance's bits differ from the "
             "resident instance's at beam 10")
    S, L = rec.net.generator.dim_dec, d["pre"].shape[1]
    plan = beam_loop_plan(dict(
        K=10, L=L, M=d["pre"].shape[2], D=d["attended"].shape[2], S=S,
        R=250, V=rec.num_phonemes, F=tables["embed"].shape[1],
        Lout=kw["max_len"], n_taps=tables["conv_filters"].shape[-1]),
        phase="25b", instance="workspace")
    results["beam_search_loop_ws"]["beam10_bits"] = dict(
        resident_ms=ms["resident"], workspace_ms=ms["workspace"], **plan)
    log(f"phase 25b beam 10, U={U}, {frames} frames: the workspace "
        f"instance gives the resident instance's bits; resident "
        f"{ms['resident']:.3f} ms, workspace {ms['workspace']:.3f} ms")


def routed_decode(dev, name, net, feats, fmask, eos_bias, search_kw):
    """Phase 25c: ``beam_search`` of ``net`` (random weights from seed
    1234, the EOS logit raised by ``eos_bias``) at beam 10: ``loop_route``
    holds it, the workspace instance launches and neither the resident
    instance nor the energy kernel does; the hypotheses are the plain
    loop's (phase 3's comparison) and the best of each utterance the
    module route's under ``use_pallas: never`` (at most one near tie,
    costs within 1e-4 relative).  Returns (launches, seconds on each
    route)."""
    import torch
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from attention_lvcsr_torch.ops import attention_energy as ae
    from attention_lvcsr_torch.ops import beam_loop as bl
    from attention_lvcsr_torch.search import beam as beam_mod
    U, frames = feats.shape[:2]
    recs = {}
    for route in ("loop", "never"):
        recs[route] = SpeechRecognizer(
            dict(net, use_pallas="auto" if route == "loop" else "never"),
            init_config=FLAGSHIP_INIT, seed=1234, device=dev)
        readout = recs[route].net.generator.readout
        readout.post_merge_0.bias.data[recs[route].eos_label] += eos_bias
        recs[route].init_beam_search(10)
    cap = int(frames / net["max_decoded_length_scale"])
    if not beam_mod.loop_route(recs["loop"].net_config, 10, frames):
        fail(f"phase 25c {name}: loop_route leaves the loop kernel")
    counters = {"beam_search_loop": bl.launches,
                "beam_search_loop_ws": bl.launches_ws,
                "beam_attention_energies": ae.launches}
    outs, walls, moved = {}, {}, {}
    plain = [(beam_mod, "beam_search_loop", bl.beam_search_loop_reference)]
    for route, rec, swap in (("loop", recs["loop"], []),
                             ("plain", recs["loop"], plain),
                             ("never", recs["never"], [])):
        for c in counters.values():
            c.reset()
        with swapped(swap):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[route] = rec.beam_search(feats, fmask, as_arrays=True,
                                          **search_kw)
            torch.cuda.synchronize()
            walls[route] = time.perf_counter() - t0
        moved[route] = counts(counters)
    if moved["loop"]["beam_search_loop_ws"] != 1 or moved["loop"][
            "beam_search_loop"] or moved["loop"]["beam_attention_energies"]:
        fail(f"phase 25c {name}: launches {moved['loop']} on the loop "
             f"route")
    if moved["never"]["beam_search_loop"] or moved["never"][
            "beam_search_loop_ws"]:
        fail(f"phase 25c {name}: the module route launched the loop "
             f"kernel: {moved['never']}")
    err = compare_outputs(f"phase 25c {name}", outs["loop"], outs["plain"])
    best_g, best_r = (best_hypotheses(outs[r]) for r in ("loop", "never"))
    differ, worst = [], 0.0
    for u, ((h, c), (rh, rc)) in enumerate(zip(best_g, best_r)):
        if h == rh and (c is None) == (rc is None) and (
                c is None or abs(c - rc) <= 1e-4 * max(abs(rc), 1.0)):
            worst = max(worst, 0.0 if c is None else abs(c - rc))
            continue
        if c is None or rc is None or abs(c - rc) > 1e-3 * max(abs(rc), 1):
            fail(f"phase 25c {name}: utterance {u}: {h} ({c}) on the loop "
                 f"route vs {rh} ({rc}) on the module route")
        differ.append(u)
    eos = recs["loop"].eos_label
    found = sum(c is not None and any(x != eos for x in h)
                for h, c in best_g)
    if len(differ) > 1 or found <= U // 2:
        fail(f"phase 25c {name}: {len(differ)} near ties against the module "
             f"route, {found}/{U} hypotheses with a symbol besides EOS")
    log(f"phase 25c {name} U={U}, {frames} frames, beam 10, cap {cap}: the "
        f"workspace instance ({moved['loop']}), the plain loop's outputs "
        f"(max abs cost err {err:.3e}), the module route's best hypotheses "
        f"(near ties {differ}, costs within {worst:.2e}; its launches "
        f"{moved['never']}); {found}/{U} with a symbol besides EOS; "
        f"{walls['loop']:.3f} s on the loop, {walls['plain']:.3f} s plain, "
        f"{walls['never']:.3f} s on the module route")
    return moved["loop"], walls


def long_decodes(t, dev, rates):
    """Phase 25c: wsj_jan_wsj13v2.yaml's decode of 800 frames (L=400, its
    266-step cap, the window around the mean) and wsj_pyramide.yaml's
    (D=2000, L=200, the window around the median), 16 utterances each,
    whose resident layouts pass a block (``routed_decode``).  Returns the
    launches of each."""
    rng = np.random.RandomState(251)
    U, frames = 16, 800
    feats = t(rng.randn(U, frames, 123))
    lengths = rng.randint(600, frames + 1, size=U)
    lengths[0] = frames
    fmask = t(np.arange(frames)[None] < lengths[:, None])
    moved = {}
    for name, net in (
            ("wsj13v2", dict(stacked_nets()["wsj13v2"],
                             max_decoded_length_scale=3.0)),
            ("wsj_pyramide", dict(pyramide_net(),
                                  max_decoded_length_scale=3.0))):
        moved[name], walls = routed_decode(
            dev, name, net, feats, fmask, LONG_EOS_BIAS[name], LONG_SEARCH)
        for route, wall in walls.items():
            rates[f"{name}_800_{route}_utt_per_s"] = U / wall
    return moved


# the random models' decodes in 25c: a raised EOS logit lets most
# hypotheses finish within the 266-step caps with a symbol besides EOS
LONG_EOS_BIAS = {"wsj13v2": 3.0, "wsj_pyramide": 6.0}
LONG_SEARCH = {"char_discount": 3.0, "stop_on": "optimistic_future_cost"}


def wide_search(t, dev, rates):
    """Phase 25d: ``run_search`` (what ``run.py search`` runs) on the
    flagship with decode.sh's no-LM settings (``beam_size`` 200,
    ``char_discount`` 0.1, ``net.prior.before`` 10; random weights from
    seed 1234, which finish most hypotheses there with a symbol besides
    EOS, where a raised EOS logit would end most of them at once) over
    phase 18's 16 utterances in one chunk: the workspace instance launches once and
    the resident one not; the report agrees with the module route's under
    ``net.use_pallas never`` (``reports_agree``); utt/s of both; then
    beam 513 over two of them: the loop kernel does not launch.  Returns
    the loop route's launches."""
    import torch
    from __graft_entry__ import FLAGSHIP_NET
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from attention_lvcsr_torch.ops import attention_energy as ae
    from attention_lvcsr_torch.ops import beam_loop as bl
    from attention_lvcsr_torch.ops import gru_scan as gs
    from attention_lvcsr_torch.train.checkpoint import save_checkpoint
    from attention_lvcsr_torch.train.driver import create_model, run_search
    net = {k: v for k, v in FLAGSHIP_NET.items()
           if k not in ("input_dims", "input_num_chars", "eos_label",
                        "num_phonemes")}
    net["prior"] = dict(net["prior"], before=10)      # decode.sh's override
    data = SmokeData()
    tmp = tempfile.mkdtemp()
    try:
        ckpt = os.path.join(tmp, "flagship.zip")
        rec = SpeechRecognizer(FLAGSHIP_NET, init_config=FLAGSHIP_INIT,
                               seed=1234, device=dev)
        save_checkpoint(ckpt, rec.param_path_dict())
        models = {route: create_model(
            {"net": dict(net, use_pallas=route)}, data, ckpt, device=dev)
            for route in ("auto", "never")}
    finally:
        shutil.rmtree(tmp)
    counters = {"gru_scan": gs.launches, "beam_search_loop": bl.launches,
                "beam_search_loop_ws": bl.launches_ws,
                "beam_attention_energies": ae.launches}
    examples = search_examples()

    def drive(route, beam, n):
        conf = {"beam_size": beam, "char_discount": 0.1, "decode_batch": n}
        buf = io.StringIO()
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = run_search(models[route], [dict(ex) for ex in examples[:n]],
                           data, conf, print_to=buf)
        torch.cuda.synchronize()
        return buf.getvalue(), stats, time.perf_counter() - t0, counts(
            counters)

    report, stats, wall, moved = drive("auto", 200, 16)
    if moved["beam_search_loop_ws"] != 1 or moved["beam_search_loop"] \
            or moved["beam_attention_energies"]:
        fail(f"phase 25d: launches {moved} at beam 200")
    ref, ref_stats, ref_wall, ref_moved = drive("never", 200, 16)
    if ref_moved["beam_search_loop_ws"] or ref_moved["beam_search_loop"] \
            or not ref_moved["beam_attention_energies"]:
        fail(f"phase 25d: launches {ref_moved} under use_pallas never")
    err = reports_agree("phase 25d", report, ref, list(range(16)), stats,
                        ref_stats)
    nonempty = sum(bool(u.get("Recognized")) for u in parse_report(report))
    if nonempty <= 8:
        fail(f"phase 25d: {nonempty} of 16 utterances recognized anything")
    rates["wide_search_loop_utt_per_s"] = 16 / wall
    rates["wide_search_module_utt_per_s"] = 16 / ref_wall
    _, _, wide_wall, wide_moved = drive("auto", 513, 2)
    if wide_moved["beam_search_loop"] or wide_moved["beam_search_loop_ws"] \
            or not wide_moved["beam_attention_energies"]:
        fail(f"phase 25d: launches {wide_moved} at beam 513")
    log(f"phase 25d run_search, beam 200, char_discount 0.1, prior before "
        f"10, 16 utterances in one chunk: {nonempty} recognized something, "
        f"the module route's report (max rel cost err {err:.2e}); "
        f"{16 / wall:.2f} utt/s on the loop kernel ({moved}), "
        f"{16 / ref_wall:.2f} on the module route ({ref_moved}); beam 513 "
        f"over 2: the module route ({wide_moved}), {wide_wall:.2f} s")
    return moved


def resident_loop_bits(t, dev):
    """The resident loop instances on the main paths of phases 3 (the
    flagship, median window), 20b (content attention at the TIMIT widths),
    22a (ten filters + maxout:2 + states, the mean window) and 23a
    (wsj13v2's two layers, the mean window): U=64, beam 10, a 100-step
    cap, random weights from seed 1234 and the EOS logit raised by 1.5:
    the sha256 of each decode's outputs and its time.  Only what every
    commit since the stacked decoders has: ``beam_search_loop``'s default
    route.  Returns ({name: sha256}, {name: ms})."""
    import hashlib
    import torch
    from __graft_entry__ import FLAGSHIP_NET
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from attention_lvcsr_torch.ops import beam_loop as bl
    digest = lambda xs: hashlib.sha256(b"".join(
        x.contiguous().cpu().numpy().tobytes() for x in xs)).hexdigest()
    rng = np.random.RandomState(255)
    U = 64
    nets = {"flagship": (FLAGSHIP_NET, 800),
            "content": (dict(TIMIT_NET, input_dims={"recordings": 123},
                             eos_label=CHAR_MAP["<eol>"],
                             num_phonemes=len(CHARS)), 700),
            "maxout10_mean": (variant_nets()["mean_maxout"], 800),
            "stack2_mean": (dict(stacked_nets()["wsj13v2"],
                                 dims_bidir=[256] * 4,
                                 subsample=[1, 1, 2, 2]), 800)}
    hashes, times = {}, {}
    for name, (net, frames) in nets.items():
        rec = SpeechRecognizer(dict(net, max_decoded_length_scale=8.0),
                               init_config=FLAGSHIP_INIT, seed=1234,
                               device=dev)
        feats = torch.tensor(rng.randn(U, frames, 123).astype(np.float32),
                             device=dev)
        lengths = rng.randint(frames * 3 // 4, frames + 1, size=U)
        lengths[0] = frames
        fmask = torch.tensor((np.arange(frames)[None] < lengths[:, None])
                             .astype(np.float32), device=dev)
        att = rec.net.generator.attention
        with torch.inference_mode():
            d = rec.net.decode_loop(feats, fmask)
            tables = dict(rec.net.decode_loop_tables())
        tables["post_b"] = tables["post_b"].clone()
        tables["post_b"][rec.eos_label] += 1.5
        prior = att.prior_config(d["attended"].shape[1] + 1)
        kw = dict(beam=10, max_len=100, eol=rec.eos_label,
                  ignore_first_eol=True, content_attention=not att.conv,
                  post_act=rec.net.generator.readout.activation,
                  prior=prior.get("type", "expanding"),
                  **{k: float(v) for k, v in prior.items() if k != "type"})
        args = (d["pre"], d["attended"], d["attended_mask"], tables)
        hashes[name] = digest(bl.beam_search_loop(*args, **kw))
        times[name] = cuda_ms(lambda: bl.beam_search_loop(*args, **kw), 5)
    return hashes, times


# resident_loop_bits' hashes of the tree before the workspace instances
# (commit 954c342, tools/torch_gru_bits.py --loop on an H100): the
# resident instances kept their code, so their outputs keep these bits
RESIDENT_LOOP_BITS = {
    "flagship":
        "2e00a180bf37abdfdfc95d3413900f49fca45914d9915b1beee30e68e3e9f60e",
    "content":
        "f739d59100641f6a9cd830ec3399c2377c386789ea6670cfff0989a3f5547424",
    "maxout10_mean":
        "3a5aaa691698259a6773e6b493832b493ae349f806a0718eab9e7231a1f2333b",
    "stack2_mean":
        "660e9e580c08f3fcd7abc16c0c6b5817710ff432a7f07d62a41910bcf80289e1"}


def resident_loop_check(t, dev, rates):
    """Phase 25e: the resident loop instances (``resident_loop_bits``)
    hash to the bits of the tree before the workspace instances; their
    times beside them."""
    hashes, times = resident_loop_bits(t, dev)
    differ = sorted(k for k, v in hashes.items()
                    if RESIDENT_LOOP_BITS.get(k) != v)
    if differ:
        fail(f"phase 25e: the resident loop instances changed their bits: "
             f"{differ} ({hashes})")
    rates.update({f"resident loop {k} ms": v for k, v in times.items()})
    log(f"phase 25e resident loop instances: {len(hashes)} decodes hash to "
        f"the earlier tree's bits; " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in times.items()))


def selection_check(t, dev, results):
    """Phase 25f: the workspace instances' one-pass selection (``select_k``,
    through ``csrc/beam_loop_ws.cu``'s test entry, ``beam_select``)
    against the resident instances' K rounds of ``block_argmin`` in the
    same launch, on ``ops/beam_loop.py::selection_grids`` (the CPU test's
    grids: ties, +-0.0, rows at INF and at BIG, all at BIG, a mix with
    +inf) at K in {1, 17, 18, 200, 512} and V in {5, 32}: identical
    source rows, symbols and cost bits, and the plain version's picks."""
    import torch
    from attention_lvcsr_torch.ops import beam_loop as bl
    bits = lambda x: x.contiguous().cpu().numpy().tobytes()
    checked = 0
    for K in (1, 17, 18, 200, 512):
        for V in (5, 32):
            grids = bl.selection_grids(K, V)
            costs = torch.tensor(np.stack(list(grids.values())), device=dev)
            bl.launches_select.reset()
            picks = bl.beam_select(costs)
            torch.cuda.synchronize()
            if bl.launches_select.count != 1:
                fail(f"phase 25f: beam_select launched "
                     f"{bl.launches_select.count} times")
            plain = bl.beam_select_reference(costs)
            for i, name in enumerate(grids):
                for part, a, b, c in zip(("src", "sym", "chosen"),
                                         picks["pass"], picks["rounds"],
                                         plain):
                    if not bits(a[i]) == bits(b[i]) == bits(c[i]):
                        fail(f"phase 25f: K={K} V={V} grid {name}: the "
                             f"selection's {part} differs from the rounds' "
                             f"or the plain version's")
                checked += 1
    results["beam_search_loop_ws"]["selection_grids"] = checked
    log(f"phase 25f: the one-pass selection takes the K rounds' picks, "
        f"bit for bit, on {checked} grids (K 1-512, V 5 and 32)")


def workspace_phase(t, dev, results, rates):
    """Phase 25: the loop kernel's workspace instances.  Returns 25c's and
    25d's launches."""
    results.setdefault("beam_search_loop_ws", {})
    t0 = time.perf_counter()
    selection_check(t, dev, results)
    log(f"phase 25f: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    wide_beam_loops(t, dev, results)
    log(f"phase 25a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    workspace_bits(t, dev, results)
    log(f"phase 25b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moved = long_decodes(t, dev, rates)
    log(f"phase 25c: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moved["wide search"] = wide_search(t, dev, rates)
    log(f"phase 25d: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    resident_loop_check(t, dev, rates)
    log(f"phase 25e: {time.perf_counter() - t0:.1f} s")
    return moved


ROOT = os.path.dirname(os.path.abspath(__file__))
# exp/wsj/make_lm_graph.sh's steps with its third argument (the network's
# characters), in its order; create-lexicon writes into the working
# directory and the script moves its three files into the graph's
RECIPE_STEPS = (
    ("arpa2fst", "lm.arpa", "graph/G.fst.txt"),
    ("arpa-to-unigram", "lm.arpa", "graph/unigram.arpa"),
    ("arpa-to-dict", "lm.arpa", "graph/dict.arpa"),
    ("create-lexicon", "lm.arpa"),
    ("pack", "graph/G.fst.txt", "graph/G.packed.npz"),
    ("build-lg", "lm.arpa", "net_chars.txt", "graph"))
# exp/wsj/decode.sh's settings of an LM decode; the graph ends the random
# model's hypotheses on its words, so the EOS logit is not raised (26c
# fails where more than half of them are empty)
RECIPE_LM = {"weight": 0.5, "no_transition_cost": 20.0}
RECIPE_SEARCH = {"beam_size": 10, "char_discount": 1.0, "decode_batch": 16}
PACKED = ("next_state", "next_weight", "total_weight", "start_states",
          "start_weights")


def lm_tool(argv, cwd):
    """One step of the port's LM-graph command line in ``cwd``, in a
    process of its own: (stdout, seconds).  A nonzero exit fails."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "attention_lvcsr_torch.cli.lm_tools", *argv],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    seconds = time.perf_counter() - t0
    if proc.returncode:
        fail(f"phase 26b lm_tools {' '.join(argv)}: exit {proc.returncode}"
             f"\n{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    return proc.stdout, seconds


def recipe_graph(tmp):
    """Phase 26a-b: a seeded 60-word trigram and the network's characters
    written into ``tmp``; ``make_lm_graph.sh``'s steps through the port's
    command line; ``LG_pushed.fst.txt`` with its ``.syms`` packed again
    (``pack --char-map``) to the tables of ``LG_pushed.npz``.  Returns
    (the words, the graph's directory)."""
    text, words = word_trigram_arpa()
    with open(os.path.join(tmp, "lm.arpa"), "w") as f:
        f.write(text)
    with open(os.path.join(tmp, "net_chars.txt"), "w") as f:
        f.write("".join(f"{c} {i}\n" for c, i in CHAR_MAP.items()))
    graph = os.path.join(tmp, "graph")
    os.makedirs(graph)
    seconds = {}
    for argv in RECIPE_STEPS:
        out, seconds[argv[0]] = lm_tool(list(argv), tmp)
        if argv[0] == "create-lexicon":
            for name in ("lexicon.txt", "words.txt", "characters.txt"):
                os.replace(os.path.join(tmp, name),
                           os.path.join(graph, name))
        if argv[0] == "build-lg":
            states = int(out.split("LG_pushed=")[1].split()[0])
    _, seconds["pack LG_pushed"] = lm_tool(
        ["pack", "--char-map", "net_chars.txt", "graph/LG_pushed.fst.txt",
         "graph/LG_repacked.npz"], tmp)
    with np.load(os.path.join(graph, "LG_pushed.npz")) as a, \
            np.load(os.path.join(graph, "LG_repacked.npz")) as b:
        for key in PACKED:
            if not np.array_equal(a[key], b[key]):
                fail(f"phase 26b: LG_pushed.fst.txt packs to another "
                     f"{key} than LG_pushed.npz holds")
        shape = a["next_state"].shape
    log(f"phase 26b make_lm_graph.sh's steps on a 60-word trigram (150 "
        f"bigrams, 150 trigrams), seconds each: "
        f"{json.dumps({k: round(v, 3) for k, v in seconds.items()})}; "
        f"LG_pushed {states} states, tables {shape}, its text packs to the "
        f"same tables")
    return words, graph


def recipe_examples(words):
    """``search_examples()``'s 16 recordings with transcripts of 2-6 of
    the LM's words (``<spc>`` between words, BOS before, EOS after), so
    that the WER counts words of the vocabulary."""
    rng = np.random.RandomState(26)
    examples = search_examples()
    for ex in examples:
        chosen = [words[i] for i in rng.randint(len(words),
                                                 size=rng.randint(2, 7))]
        chars = list("\x00".join(chosen))
        ex["labels"] = np.asarray(
            [CHAR_MAP["<bol>"]]
            + [CHAR_MAP["<spc>" if c == "\x00" else c] for c in chars]
            + [CHAR_MAP["<eol>"]], np.int64)
        ex["transcript"] = " ".join(chosen)
    return examples


def recipe_search(dev, graph, examples, tmp):
    """Phase 26c: ``run_search`` with decode.sh's LM settings (the graph's
    ``LG_pushed.npz`` and ``words.txt``, weight 0.5, no_transition_cost 20,
    char_discount 1.0, ``net.prior.before`` 10) at beam 10 over the
    examples in one chunk, on each route on the same weights (the
    flagship from seed 1234), each saving its decodes
    (``decoded_save``).  The plain route swaps the decode's kernels for
    their plain versions; both routes analyse the groundtruth and the
    hypotheses on the training kernels (phase 18 holds those to theirs,
    which here would take most of the phase).  Returns {route: (report,
    stats, seconds, launches, decoded file)}."""
    import torch
    from __graft_entry__ import FLAGSHIP_NET
    from attention_lvcsr_torch.models import attention as attention_mod
    from attention_lvcsr_torch.models import cells as cells_mod
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from attention_lvcsr_torch.ops import attention_energy as ae
    from attention_lvcsr_torch.ops import beam_loop as bl
    from attention_lvcsr_torch.ops import decoder_train as dt
    from attention_lvcsr_torch.ops import gru_scan as gs
    from attention_lvcsr_torch.ops import gru_train as gt
    from attention_lvcsr_torch.train.checkpoint import save_checkpoint
    from attention_lvcsr_torch.train.driver import (create_model,
                                                    read_vocabulary,
                                                    run_search)
    counters = {"gru_scan": gs.launches, "beam_search_loop": bl.launches,
                "beam_search_loop_ws": bl.launches_ws,
                "beam_attention_energies": ae.launches,
                "gru_scan_train_bidir": gt.launches_bidir,
                "decoder_scan_train": dt.launches}
    plain = [(cells_mod, "gru_scan", gs.gru_scan_reference),
             (attention_mod, "beam_attention_energies",
              ae.beam_attention_energies_reference)]
    net = {k: v for k, v in FLAGSHIP_NET.items()
           if k not in ("input_dims", "input_num_chars", "eos_label",
                        "num_phonemes")}
    net["prior"] = dict(net["prior"], before=10)      # decode.sh's override
    net["lm"] = dict(RECIPE_LM, path=os.path.join(graph, "LG_pushed.npz"))
    data = SmokeData()
    ckpt = os.path.join(tmp, "flagship.zip")
    rec = SpeechRecognizer(FLAGSHIP_NET, init_config=FLAGSHIP_INIT,
                           seed=1234, device=dev)
    save_checkpoint(ckpt, rec.param_path_dict())
    model = create_model({"net": net}, data, ckpt, device=dev)
    vocabulary = read_vocabulary(os.path.join(graph, "words.txt"))
    out = {}
    for route in ("kernels", "plain"):
        decoded = os.path.join(tmp, f"decoded_{route}.txt")
        buf = io.StringIO()
        with swapped(plain if route == "plain" else []):
            for c in counters.values():
                c.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = run_search(
                model, [{k: v for k, v in ex.items() if k != "transcript"}
                        for ex in examples], data, RECIPE_SEARCH,
                vocabulary=vocabulary, decoded_save=decoded, print_to=buf)
            torch.cuda.synchronize()
            out[route] = (buf.getvalue(), stats, time.perf_counter() - t0,
                          counts(counters), decoded)
    return out


def recipe_score(examples, report, decoded, graph, tmp):
    """Phase 26d: the decodes scored as ``decode_and_score.sh`` scores
    them: ``decoded_save``'s characters mapped to words through the
    lexicon (``tools/decoded_chars_to_words.py``), then ``python -m
    attention_lvcsr_torch.cli.score --per-utt`` against the transcripts.
    Each utterance's errors over its words, capped at 1, must be the WER
    the report gives it, and the report's average WER (run_search weights
    each utterance by its characters, as the reference's report does) is
    rebuilt from them.  Returns (score's last line, the report's average
    WER)."""
    refs = os.path.join(tmp, "ref.txt")
    with open(refs, "w") as f:
        f.write("".join(f"{ex['uttids']} {ex['transcript']}\n"
                        for ex in examples))
    hyps = os.path.join(tmp, "hyp_words.txt")
    for argv in ([os.path.join(ROOT, "tools", "decoded_chars_to_words.py"),
                  os.path.join(graph, "lexicon.txt"), decoded, hyps],
                 ["-m", "attention_lvcsr_torch.cli.score", refs, hyps,
                  "--per-utt"]):
        proc = subprocess.run([sys.executable, *argv], cwd=tmp,
                              capture_output=True, text=True, timeout=120,
                              env=dict(os.environ, PYTHONPATH=ROOT))
        if proc.returncode:
            fail(f"phase 26d {argv[0]}: exit {proc.returncode}\n"
                 f"{proc.stderr[-2000:]}")
    per_utt = {}
    for line in proc.stdout.splitlines()[:-1]:
        uttid, errors, length, _ = line.split()
        per_utt[uttid] = (int(errors.split("=")[1]),
                          int(length.split("=")[1]))
    utts = parse_report(report)
    if len(per_utt) != len(examples) or len(utts) != len(examples):
        fail(f"phase 26d: {len(per_utt)} scored and {len(utts)} reported "
             f"utterances, {len(examples)} decoded")
    weighted = total = 0.0
    for ex, u in zip(examples, utts):
        errors, length = per_utt[ex["uttids"]]
        wer_u = min(1.0, errors / length)
        if abs(wer_u - float(u["WER"])) > 1e-12:
            fail(f"phase 26d: {ex['uttids']} scored {errors}/{length} "
                 f"words, the report's WER {u['WER']}")
        chars = len(ex["labels"]) - 2
        weighted += chars * wer_u
        total += chars
    average = float(utts[-1]["Average WER"])
    if abs(weighted / total - average) > 1e-12:
        fail(f"phase 26d: the scored utterances average {weighted / total} "
             f"over characters, the report {average}")
    return proc.stdout.splitlines()[-1], average


def recipe_phase(t, dev, rates):
    """Phase 26: the recipe tools on the card.  (a-b) the port's LM-graph
    command line builds a 60-word trigram's decoding graph as
    ``make_lm_graph.sh`` builds it; (c) ``run_search`` with decode.sh's LM
    settings on that graph at beam 10 over 16 utterances in one chunk, on
    the kernels and on the plain route: the same hypotheses (phase 18's
    ``reports_agree``, no near tie allowed), beam search costs within
    phase 8's tolerance, ``gru_scan``, ``beam_attention_energies`` and the
    analyses' training kernels launched, the loop kernel not, at most half
    of the hypotheses empty; (d) ``cli.score`` reproduces the report's
    WER.  Returns the kernel route's launches."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp()
    try:
        words, graph = recipe_graph(tmp)
        t_graph = time.perf_counter() - t0
        examples = recipe_examples(words)
        runs = recipe_search(dev, graph, examples, tmp)
        report, stats, wall, moved, decoded = runs["kernels"]
        ref, ref_stats, ref_wall, ref_moved, _ = runs["plain"]
        used = ("gru_scan", "beam_attention_energies", "gru_scan_train_bidir",
                "decoder_scan_train")
        if min(moved[k] for k in used) < 1 or moved["beam_search_loop"] \
                or moved["beam_search_loop_ws"]:
            fail(f"phase 26c: launches {moved}, expected each of {used} "
                 f"and no loop kernel")
        if ref_moved["gru_scan"] or ref_moved["beam_attention_energies"]:
            fail(f"phase 26c: the plain route's decode launched kernels: "
                 f"{ref_moved}")
        got_utts, ref_utts = parse_report(report), parse_report(ref)
        for u, (a, b) in enumerate(zip(got_utts, ref_utts)):
            if a.get("Recognized") != b.get("Recognized"):
                fail(f"phase 26c: utterance {u} recognized "
                     f"{a.get('Recognized')!r} on the kernels, "
                     f"{b.get('Recognized')!r} on the plain route")
            x, y = float(a["Beam search cost"]), float(b["Beam search cost"])
            if np.isfinite(y) and not abs(x - y) <= 1e-4 + 1e-5 * abs(y):
                fail(f"phase 26c: utterance {u} beam search cost {x} vs "
                     f"plain {y}")
        err = reports_agree("phase 26c", report, ref,
                            list(range(len(examples))), stats, ref_stats)
        if stats["total_wer_errors"] != ref_stats["total_wer_errors"]:
            fail(f"phase 26c: WER errors {stats['total_wer_errors']} vs "
                 f"plain {ref_stats['total_wer_errors']}")
        nonempty = sum(bool(u.get("Recognized")) for u in got_utts)
        if 2 * nonempty < len(examples):
            fail(f"phase 26c: {nonempty} of {len(examples)} hypotheses are "
                 f"not empty: the comparison is too weak")
        in_vocab = sum(w in words for u in got_utts
                       for w in u.get("Recognized", "").split())
        rates["recipe_search_utt_per_s"] = len(examples) / wall
        rates["plain_recipe_search_utt_per_s"] = len(examples) / ref_wall
        log(f"phase 26c run_search with decode.sh's LM settings (weight 0.5,"
            f" no_transition_cost 20, char_discount 1.0, prior before 10, "
            f"the graph's words.txt), beam 10, {len(examples)} utterances in "
            f"one chunk, random weights, the EOS logit not raised: "
            f"{nonempty} non-empty hypotheses ({in_vocab} words of the "
            f"vocabulary), the same on the plain route (max rel cost err "
            f"{err:.2e}); average WER "
            f"{stats['total_wer_errors'] / stats['total_word_length']:.4f}, "
            f"CER {stats['total_errors'] / stats['total_length']:.4f}; "
            f"kernels {len(examples) / wall:.2f} utt/s, plain "
            f"{len(examples) / ref_wall:.2f} utt/s; launches {moved}")
        line, average = recipe_score(examples, report, decoded, graph, tmp)
        log(f"phase 26d cli.score on the decodes: every utterance's WER and "
            f"the report's average {average:.6f} reproduced (score's own "
            f"total, over words: {line})")
    finally:
        shutil.rmtree(tmp)
    log(f"phase 26: graph {t_graph:.1f} s, all {time.perf_counter() - t0:.1f}"
        f" s")
    return moved



# Phase 27: wsj_paper.yaml's network with dropout and additive weight
# noise, and the training services
SERVICES_NOISE = 0.01
SERVICES_SEED = 1234
SERVICES_SHAPE = (32, 800, 100)         # B, frames, labels: phase 13's
# the launches phase 27b's trace must name: the GRU training backward and
# the training decoder's forward and backward (csrc/gru_train.cu,
# csrc/decoder_train.cu)
SERVICES_TRACE_KERNELS = ("gru_bwd_kernel", "decoder_fwd_kernel",
                          "decoder_bwd_kernel")


def services_config(net):
    """wsj_paper.yaml's main stage over ``net`` with the phase's
    regularizers, changed as ``run.py train``'s trailing pairs change it
    (values already typed: the card machine has no yaml)."""
    from attention_lvcsr_torch.config import make_config_changes
    config = copy.deepcopy(dict(WSJ_PAPER, net=net,
                                initialization=FLAGSHIP_INIT))
    make_config_changes(config, [
        ("regularization.dropout", True),
        ("regularization.noise", SERVICES_NOISE),
        ("training.seed", SERVICES_SEED)])
    return config


def services_arrays(n, seed, shape=SERVICES_SHAPE):
    """``n`` flagship batches of ``shape`` (B, frames, labels) as numpy
    arrays (a ``MultiProcessStream`` worker makes them): ragged frames and
    labels, row 0 full, every row's labels ending in EOS."""
    B, T, TL = shape
    V = len(CHARS)
    rng = np.random.RandomState(seed)
    for _ in range(n):
        frames = rng.randint(T * 3 // 4, T + 1, size=B)
        lengths = rng.randint(TL * 3 // 4, TL + 1, size=B)
        frames[0], lengths[0] = T, TL
        labels = rng.randint(0, V - 2, size=(B, TL))
        labels[np.arange(B), lengths - 1] = CHAR_MAP["<eol>"]
        yield {"recordings": rng.randn(B, T, 123).astype(np.float32),
               "recordings_mask": (np.arange(T)[None] < frames[:, None])
               .astype(np.float32),
               "labels": labels.astype(np.int64),
               "labels_mask": (np.arange(TL)[None] < lengths[:, None])
               .astype(np.float32)}


def services_step_check(t, dev, rates):
    """Phase 27a; returns the kernel step's launches."""
    import torch
    from __graft_entry__ import FLAGSHIP_NET
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from attention_lvcsr_torch.train import driver
    from attention_lvcsr_torch.train.monitoring import batch_tensors
    from attention_lvcsr_torch.train.rules import build_optimizer
    from attention_lvcsr_torch.models import cells as cells_mod
    from attention_lvcsr_torch.models import generator as generator_mod
    from attention_lvcsr_torch.ops import decoder_train as dt
    from attention_lvcsr_torch.ops import gru_train as gt
    config = services_config(dict(FLAGSHIP_NET))
    net = dict(FLAGSHIP_NET, dropout=True)
    counters = train_counters()

    def model():
        return SpeechRecognizer(net, init_config=FLAGSHIP_INIT,
                                seed=SERVICES_SEED, device=dev)

    rec = model()
    batch = batch_tensors(next(services_arrays(1, 27, SERVICES_SHAPE)), rec)
    noise, mask = driver.regularization_draws(
        rec, config, batch[0].shape,
        driver.noise_generator(dev, SERVICES_SEED, 0))
    spared = {k for k in rec.parameters() if "/generator/attention/" in k}
    kept = float(mask.float().mean())
    if set(noise) != set(rec.parameters()) - spared or not spared \
            or abs(kept - 0.5) > 0.02 \
            or tuple(mask.shape) != SERVICES_SHAPE[:2] + (123,):
        fail(f"phase 27a: noised {len(noise)} of {len(rec.parameters())} "
             f"parameters ({len(spared)} attention ones spared), mask "
             f"{tuple(mask.shape)} keeping {kept:.4f}")

    def cost_and_grads(rec):
        """The step's forward and backward on the noised weights."""
        params = rec.parameters()
        means = {k: p.detach().clone() for k, p in params.items()}
        with torch.no_grad():
            for k in noise:
                params[k].copy_(means[k] + SERVICES_NOISE * noise[k])
        rec.net.requires_grad_(True)
        try:
            out = rec.net.cost(*batch, train=True, dropout_mask=mask)
            cost = out["costs"].sum() / batch[0].shape[0]
            grads = torch.autograd.grad(cost, list(params.values()))
        finally:
            rec.net.requires_grad_(False)
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(means[k])
        torch.cuda.synchronize()
        return out, cost.detach(), dict(zip(params, grads))

    plain = [(cells_mod, "gru_scan_train", gt.gru_scan_train_reference),
             (generator_mod, "decoder_scan_train",
              dt.decoder_scan_train_reference)]
    t0 = time.perf_counter()
    with swapped(plain):
        for c in counters.values():
            c.reset()
        ref, ref_cost, ref_grads = cost_and_grads(model())
        if any(counters[k].count for k in TRAIN_KERNELS):
            fail(f"phase 27a: the plain route launched kernels: "
                 f"{counts(counters)}")
    plain_s = time.perf_counter() - t0
    out, cost, grads = cost_and_grads(rec)
    state_err = max(float((out[k] - ref[k]).detach().abs().max())
                    for k in ("encoded", "weights"))
    grad_err = max(float((grads[k] - g).abs().max()) / max(
        float(g.abs().max()), 1e-30) for k, g in ref_grads.items())
    if not torch.equal(out["bottom_output"], ref["bottom_output"]) \
            or state_err > 1e-5 or grad_err > 1e-4:
        fail(f"phase 27a: the kernels' states within {state_err:.2e}, "
             f"gradients within {grad_err:.2e} of the largest, of the "
             f"plain route's")
    opt = build_optimizer(config["training"], config["regularization"])
    step = driver.make_train_step(rec, opt, config)
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    _, mon = step(opt.init(rec.optimized()), *batch, weight_noise=noise,
                  dropout_mask=mask)
    mon = {k: float(v) for k, v in mon.items()}
    step_s = time.perf_counter() - t0
    moved = counts(counters)
    if min(moved[k] for k in ("gru_scan_train_bidir", "decoder_scan_train",
                              "outer_sum")) < 1:
        fail(f"phase 27a: the step did not run through its kernels: "
             f"{moved}")
    ref_norm = float(torch.sqrt(sum((g ** 2).sum()
                                    for g in ref_grads.values())))
    rel = {"train_cost": abs(mon["train_cost"] - float(ref_cost))
           / abs(float(ref_cost)),
           "total_gradient_norm": abs(mon["total_gradient_norm"] - ref_norm)
           / ref_norm}
    if not all(np.isfinite(v) and v <= 1e-4 for v in rel.values()):
        fail(f"phase 27a: the step's monitors {mon} vs the plain route's "
             f"cost {float(ref_cost)} and gradient norm {ref_norm}")
    rates["services_step_s"] = step_s
    log(f"phase 27a one step with dropout and weight noise {SERVICES_NOISE} "
        f"(wsj_paper.yaml, B, frames, labels {SERVICES_SHAPE}): {len(noise)} "
        f"parameters noised, {len(spared)} attention ones spared; mask "
        f"{tuple(mask.shape)} keeps {kept:.4f}; states within "
        f"{state_err:.2e}, gradients within {grad_err:.2e} of their largest "
        f"value; train_cost {mon['train_cost']} (rel err "
        f"{rel['train_cost']:.2e}), total_gradient_norm "
        f"{mon['total_gradient_norm']} (rel err "
        f"{rel['total_gradient_norm']:.2e}) against the plain route; step "
        f"{step_s:.3f} s on the kernels, the plain forward and backward "
        f"{plain_s:.2f} s; launches {moved}")
    return moved


def services_stage(dev, stream, out_dir, extensions=()):
    """A four-batch ``run_stage`` of phase 27's config writing to
    ``out_dir`` (plot ``out_dir/plot``, served on a free port), the
    batches from ``stream()``.  Returns (loop, warnings logged)."""
    import logging
    from __graft_entry__ import FLAGSHIP_NET
    from attention_lvcsr_torch.config import make_config_changes
    from attention_lvcsr_torch.train.driver import create_model, run_stage
    net = {k: v for k, v in FLAGSHIP_NET.items()
           if k not in ("input_dims", "input_num_chars", "eos_label",
                        "num_phonemes")}
    config = services_config(net)
    make_config_changes(config, [
        ("training.num_batches", 4),
        ("monitoring.plot", {"path": os.path.join(out_dir, "plot"),
                             "serve": True, "port": 0})])
    data = SmokeData()

    def make_stage(config, load_path):
        return dict(recognizer=create_model(config, data, load_path,
                                            device=dev),
                    batch_stream=stream)

    warned = []

    class Warnings(logging.Handler):
        def emit(self, record):
            if record.levelno >= logging.WARNING:
                warned.append(record.getMessage())
    handler = Warnings()
    logger = logging.getLogger("attention_lvcsr_torch")
    logger.addHandler(handler)
    try:
        loop = run_stage(config, os.path.join(out_dir, "model.zip"),
                         make_stage, printing=False, extensions=extensions)
    finally:
        logger.removeHandler(handler)
    return loop, warned


def services_stage_check(dev, rates):
    """Phase 27b; returns the kernel route's launches."""
    import functools
    import torch
    from attention_lvcsr_torch.data.server import MultiProcessStream
    from attention_lvcsr_torch.train.extensions import (NanGuard, PlotServer,
                                                        ProgressBar,
                                                        TorchProfiler)
    from attention_lvcsr_torch.train.loop import TrainingExtension
    fetched = {}

    class Fetch(TrainingExtension):
        """After the epoch, ``/data.json`` from the live plot server."""

        def after_epoch(self):
            server = next(e for e in self.main_loop.extensions
                          if isinstance(e, PlotServer))
            url = f"http://127.0.0.1:{server.port}/data.json"
            with urllib.request.urlopen(url, timeout=30) as r:
                fetched["data"] = json.loads(r.read())

    counters = train_counters()
    tmp = tempfile.mkdtemp()
    try:
        profiler = TorchProfiler(os.path.join(tmp, "trace"), start_batch=1,
                                 num_batches=2)
        stream = functools.partial(services_arrays, 4, 28, SERVICES_SHAPE)
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        loop, warned = services_stage(
            dev, lambda: MultiProcessStream(stream, depth=2),
            os.path.join(tmp, "spawned"),
            [NanGuard(), ProgressBar(), profiler, Fetch()])
        torch.cuda.synchronize()
        spawned_s = time.perf_counter() - t0
        moved = counts(counters)
        t0 = time.perf_counter()
        direct, _ = services_stage(dev, stream, os.path.join(tmp, "direct"))
        direct_s = time.perf_counter() - t0
        status = loop.log.status
        times, costs = loop.log.channel("train_cost")
        missing = [k for k in ("code_version", "compile_time_s",
                               "num_compiled_shapes") if k not in status]
        if missing or times != [1, 2, 3, 4]:
            fail(f"phase 27b: status lacks {missing}; train_cost at {times}")
        if direct.log.channel("train_cost") != (times, costs):
            fail(f"phase 27b: the MultiProcessStream run's train_cost "
                 f"{costs} vs the direct stream's "
                 f"{direct.log.channel('train_cost')[1]}")
        series = [[t_, c] for t_, c in zip(times, costs)]
        with open(os.path.join(tmp, "spawned", "plot.json")) as f:
            plotted = json.load(f)
        png = os.path.exists(os.path.join(tmp, "spawned", "plot.png"))
        if plotted.get("train_cost") != series \
                or fetched.get("data", [{}])[0].get("train_cost") != series:
            fail(f"phase 27b: the log's train_cost {series}, plot.json "
                 f"{plotted.get('train_cost')}, /data.json "
                 f"{fetched.get('data')}")
        with open(profiler.path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        named = {k: sorted(n for n in names if k in n)[:2]
                 for k in SERVICES_TRACE_KERNELS}
        if not all(named.values()):
            fail(f"phase 27b: the trace of batches 2-3 names {named}")
        if any("not ported" in w for w in warned):
            fail(f"phase 27b: warned {warned}")
        if min(moved[k] for k in ("gru_scan_train_bidir", "decoder_scan_train",
                                  "outer_sum")) < 1:
            fail(f"phase 27b: the stage did not run through its kernels: "
                 f"{moved}")
        rates["services_stage_s"] = spawned_s
        log(f"phase 27b run_stage of 4 batches {SERVICES_SHAPE} with "
            f"dropout, weight noise, monitoring.plot, NanGuard, ProgressBar "
            f"and TorchProfiler, the batches from a MultiProcessStream "
            f"worker: {spawned_s:.2f} s (the direct stream's run "
            f"{direct_s:.2f} s, the same train_cost bits {costs}); "
            f"code_version {status['code_version']!r}, compile_time_s "
            f"{status['compile_time_s']:.3f}, num_compiled_shapes "
            f"{status['num_compiled_shapes']}; plot.json and /data.json "
            f"hold the log's series, plot.png "
            f"{'written' if png else 'not written (no matplotlib)'}; the "
            f"trace of batches 2-3 ({os.path.getsize(profiler.path)} bytes) "
            f"names {named}; {len(warned)} warnings; launches {moved}")
    finally:
        shutil.rmtree(tmp)
    return moved


def services_nan_check(dev):
    """Phase 27c."""
    import functools
    from __graft_entry__ import FLAGSHIP_NET
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from attention_lvcsr_torch.train.driver import run_training
    from attention_lvcsr_torch.train.extensions import NanGuard
    from attention_lvcsr_torch.train.rules import build_optimizer
    config = services_config(dict(FLAGSHIP_NET))
    rec = SpeechRecognizer(dict(FLAGSHIP_NET, dropout=True),
                           init_config=FLAGSHIP_INIT, seed=SERVICES_SEED,
                           device=dev)
    rec.net.generator.readout.post_merge_0.bias.data[0] = float("nan")
    opt = build_optimizer(config["training"], config["regularization"])
    stream = functools.partial(services_arrays, 2, 29, SERVICES_SHAPE)
    tmp = tempfile.mkdtemp()
    try:
        run_training(rec, opt, lambda: list(stream()),
                     os.path.join(tmp, "nan.zip"), config, num_batches=2,
                     fast_start=True, printing=False,
                     extensions=[NanGuard()])
    except FloatingPointError as exc:
        message = str(exc)
    else:
        fail("phase 27c: NanGuard let a NaN step pass")
    finally:
        shutil.rmtree(tmp)
    if not re.fullmatch(r"non-finite (train_cost|total_gradient_norm)=nan "
                        r"at iteration 1", message):
        fail(f"phase 27c: NanGuard raised {message!r}")
    log(f"phase 27c a step with a NaN readout bias: NanGuard raised "
        f"FloatingPointError({message!r})")


def services_native_check(rates):
    """Phase 27d."""
    from attention_lvcsr_torch.ops import error_rate, native
    if not native.available():
        fail(f"phase 27d: the native library is missing: "
             f"{native.build_info['error']}")
    rng = np.random.RandomState(30)
    B, T, A = 32, 100, len(CHARS)
    eos = CHAR_MAP["<eol>"]
    gt = rng.randint(0, A - 2, size=(T, B))
    gt[rng.randint(T // 2, T, size=B), np.arange(B)] = eos
    rec = rng.randint(0, A, size=(T, B))
    rec[rng.randint(0, T, size=B // 2), np.arange(B // 2)] = eos
    t0 = time.perf_counter()
    got = error_rate.batch_reward_and_gain(gt, rec, A, eos)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref = error_rate.batch_reward_and_gain_rows(gt, rec, A, eos)
    rows_ms = (time.perf_counter() - t0) * 1e3
    if not all(np.array_equal(a, b) for a, b in zip(got, ref)):
        fail("phase 27d: the native DP's rewards or gains differ from the "
             "numpy rows'")
    root = os.path.dirname(os.path.abspath(__file__))
    if not native.build_info["path"].startswith(
            os.path.join(root, "build", "host")):
        fail(f"phase 27d: the library is {native.build_info['path']}")
    rates["native_reward_dp_ms"] = native_ms
    rates["rows_reward_dp_ms"] = rows_ms
    log(f"phase 27d batch_reward_and_gain B={B} T={T} A={A}: the native "
        f"DP ({native.build_info['path']}, built in "
        f"{native.build_info['build_seconds']:.2f} s) {native_ms:.2f} ms, "
        f"the numpy rows {rows_ms:.2f} ms, equal integers")


def services_phase(t, dev, rates):
    """Phase 27: the training services, dropout and weight noise on the
    card.  Returns 27b's kernel-route launches."""
    t0 = time.perf_counter()
    step_moved = services_step_check(t, dev, rates)
    t1 = time.perf_counter()
    moved = services_stage_check(dev, rates)
    t2 = time.perf_counter()
    services_nan_check(dev)
    t3 = time.perf_counter()
    services_native_check(rates)
    t4 = time.perf_counter()
    log(f"phase 27: a {t1 - t0:.1f} s, b {t2 - t1:.1f} s, c {t3 - t2:.1f} "
        f"s, d {t4 - t3:.1f} s, all {t4 - t0:.1f} s; launches 27a "
        f"{step_moved}, 27b {moved}")
    return moved



# ---- 28. the model variants no recipe uses ---------------------------------

# phase 28's EOS logit raise a variant: at least half of its random
# model's utterances (three quarters on the loop kernel) must finish for
# the routes' comparison to hold hypotheses
VARIANT_EOS_BIAS = {"top_onehot": 3.0, "lstm": 1.5, "lstm_fused": 1.5,
                    "simple_rnn": 1.5}


def variant_counters():
    """Every counter a variant's decode or training step may move."""
    from attention_lvcsr_torch.ops import attention_energy as ae
    from attention_lvcsr_torch.ops import beam_loop as bl
    from attention_lvcsr_torch.ops import decode_score as ds
    return dict(train_counters(), beam_attention_energies=ae.launches,
                beam_search_loop=bl.launches,
                beam_search_loop_ws=bl.launches_ws,
                fused_decode_score=ds.launches)


def plain_decode_swaps():
    """The decode kernels' wrappers swapped for their plain versions."""
    from attention_lvcsr_torch.models import attention as attention_mod
    from attention_lvcsr_torch.models import cells as cells_mod
    from attention_lvcsr_torch.models import generator as generator_mod
    from attention_lvcsr_torch.ops import attention_energy as ae
    from attention_lvcsr_torch.ops import beam_loop as bl
    from attention_lvcsr_torch.ops import decode_score as ds
    from attention_lvcsr_torch.ops import gru_scan as gs
    from attention_lvcsr_torch.search import beam as beam_mod
    return [(cells_mod, "gru_scan", gs.gru_scan_reference),
            (attention_mod, "beam_attention_energies",
             ae.beam_attention_energies_reference),
            (beam_mod, "beam_search_loop", bl.beam_search_loop_reference),
            (generator_mod, "fused_decode_score",
             ds.fused_decode_score_reference)]


@contextlib.contextmanager
def first_call(module, name):
    """``module.name`` records the (args, kwargs) of its first call inside
    the block, into the yielded list: the operands a kernel gets on a main
    path, for timing it at those shapes."""
    calls, fn = [], getattr(module, name)

    def wrapper(*args, **kwargs):
        if not calls:
            calls.append((args, kwargs))
        return fn(*args, **kwargs)
    with swapped([(module, name, wrapper)]):
        yield calls


def kernel_at(name, kernel, plain, calls, ops, repeats=5):
    """A kernel's time at the operands of its first recorded call against
    its plain version's (forward only), the largest difference of their
    outputs and the bound of the work."""
    import torch
    args, kwargs = calls[0]
    with torch.no_grad():
        got, ref = kernel(*args, **kwargs), plain(*args, **kwargs)
    outs = lambda x: [y for y in (x if isinstance(x, tuple) else (x,))
                      if y is not None]
    err = max(float((a - b).abs().max()) for a, b in zip(outs(got),
                                                         outs(ref)))
    if not err <= 1e-3:
        fail(f"{name} disagrees with its plain version at the variant's "
             f"shapes: {err}")
    leaves = [x for a in list(args) + list(kwargs.values())
              for x in (a if isinstance(a, tuple) else (a,))
              if torch.is_tensor(x)]
    with torch.no_grad():
        return dict({"shapes": [list(x.shape) for x in leaves
                                if x.dim() >= 2][:3],
                     "max_abs_err": err,
                     "ms": cuda_ms(lambda: kernel(*args, **kwargs), repeats),
                     "plain_ms": cuda_ms(lambda: plain(*args, **kwargs), 1),
                     "library_ms": None},
                    **bound(nbytes(*leaves, *outs(got)), ops))


def variant_decode(t, dev, phase, name, net, U, frames, launched, idle,
                   rates, seed, **search_kw):
    """A beam-10 decode of ``net`` (random weights from seed 1234, the EOS
    logit raised by ``VARIANT_EOS_BIAS[name]``, a 100-step cap) through
    ``SpeechRecognizer.beam_search`` on U ragged utterances of up to
    ``frames`` frames: every counter of ``launched`` moves and none of
    ``idle``; then the same decode on the plain route, compared as in
    phase 4.  Returns the kernel route's launches."""
    import torch
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    rec = SpeechRecognizer(dict(net, max_decoded_length_scale=8.0),
                           init_config=FLAGSHIP_INIT, seed=1234, device=dev)
    rec.net.generator.readout.post_merge_0.bias.data[rec.eos_label] += \
        VARIANT_EOS_BIAS[name]
    rec.init_beam_search(10)
    rng = np.random.RandomState(seed)
    lengths = rng.randint(frames * 3 // 4, frames + 1, size=U)
    lengths[0] = frames
    feats = t(rng.randn(U, frames, 123))
    fmask = t(np.arange(frames)[None] < lengths[:, None])

    def decode():
        out = rec.beam_search(feats, fmask, as_arrays=True, **search_kw)
        torch.cuda.synchronize()
        return out

    counters = variant_counters()
    for c in counters.values():
        c.reset()
    out = decode()
    moved = counts(counters)
    if min(moved[k] for k in launched) < 1 or any(moved[k] for k in idle):
        fail(f"{name} decode: the kernels {launched} must launch and "
             f"{idle} must not: {moved}")
    _, times = timed_decodes(decode, 2)
    with swapped(plain_decode_swaps()):
        ref, ptimes = timed_decodes(decode, 1)
    err = compare_outputs(f"{name} decode", out, ref)
    finished = int(out["done_valid"].any(axis=1).sum())
    if finished < U // 2:
        fail(f"{name} decode: only {finished}/{U} utterances finished: the "
             f"comparison is too weak")
    rates[f"{name}_decode_utt_per_s"] = U / min(times)
    rates[f"plain_{name}_decode_utt_per_s"] = U / ptimes[0]
    log(f"phase {phase} {name} decode U={U} frames<={frames} beam=10 steps="
        f"{int(np.max(out['steps']))}: launches {moved}; {finished}/{U} "
        f"finished; kernel route {rates[f'{name}_decode_utt_per_s']:.2f} "
        f"utt/s ({[round(x, 3) for x in times]} s), plain route "
        f"{rates[f'plain_{name}_decode_utt_per_s']:.2f} utt/s; outputs "
        f"agree (max abs cost err {err:.3e})")
    return moved, rec


def variant_train(t, dev, phase, name, net, launched, idle, rates, seed,
                  n=2, n_plain=1):
    """``n`` training steps of ``net`` (phase 13's batches: B=32, 800
    frames, 100 labels, ragged) through ``run_training``: every counter
    of ``launched`` moves and none of ``idle``; with ``n_plain``, that
    many steps on the plain route, per-step monitors within phase 13's
    tolerance.  Returns the kernel route's launches."""
    B = 32
    batches = train_batches(t, dev, n, seed=seed)
    with tempfile.TemporaryDirectory() as tmp:
        _, _, moved, got = train_steps(dev, net, batches, n,
                                       os.path.join(tmp, "kernel.zip"))
        if any(not moved[k] for k in launched) \
                or any(moved[k] for k in idle):
            fail(f"{name} training: the kernels {launched} must launch and "
                 f"{idle} must not: {moved}")
        if not np.isfinite(got["train_cost"]).all():
            fail(f"{name} training: non-finite costs {got['train_cost']}")
        if n_plain:
            ref = plain_train_steps(dev, net, batches, n_plain,
                                    os.path.join(tmp, "plain.zip"))
            steps_agree(phase, name, got, ref)
    rates[f"{name}_train_step_utt_per_s"] = B / float(
        np.min(got["time_train_this_batch"]))
    log(f"phase {phase} {name} training B={B} frames=800 labels=100: "
        f"launches {moved}; kernel route "
        f"{rates[f'{name}_train_step_utt_per_s']:.2f} utt/s (fastest of "
        f"{n} steps, {[round(float(x), 3) for x in got['time_train_this_batch']]}"
        f" s); train_cost {got['train_cost'].tolist()}")
    return moved


def top_onehot_check(t, dev, results, rates):
    """Phase 28a: ``dims_top: [500]`` with one-hot feedback at the
    flagship's widths: the loop kernel (F = A = 33) against the plain loop
    at U=64, 800 frames, the decode through ``beam_search`` and two
    training steps against the plain route."""
    from __graft_entry__ import FLAGSHIP_NET
    net = dict(FLAGSHIP_NET, dims_top=[500], embed_outputs=False)
    U, frames = 64, 800
    rng = np.random.RandomState(28)
    feats = t(rng.randn(U, frames, 123))
    lengths = rng.randint(frames * 3 // 4, frames + 1, size=U)
    lengths[0] = frames
    fmask = t(np.arange(frames)[None] < lengths[:, None])
    loop_case(dev, results, "28a", "top_onehot", net, feats, fmask, 10,
              frames // 8, U * 3 // 4,
              eos_bias=VARIANT_EOS_BIAS["top_onehot"])
    decode = variant_decode(t, dev, "28a", "top_onehot", net, U, frames,
                            ("gru_scan", "beam_search_loop"),
                            ("beam_attention_energies",
                             "fused_decode_score"), rates, 281)[0]
    train = variant_train(t, dev, "28a", "top_onehot", net,
                          ("gru_scan_train_bidir", "decoder_scan_train",
                           "outer_sum"), ("gru_scan",), rates, 282)
    return {"top_onehot decode": decode, "top_onehot train": train}


def lstm_decoder_check(t, dev, results, rates):
    """Phase 28b: the LSTM decoder (S=250) on the flagship: the module
    decode at U=16 (gru_scan and beam_attention_energies, not the loop
    kernel), the energies kernel at its operands, a dictionary-constrained
    decode under ``use_pallas: fused`` (fused_decode_score), two training
    steps (the encoder's kernels; no decoder_scan_train) against the
    plain route."""
    from __graft_entry__ import FLAGSHIP_NET
    from attention_lvcsr_torch.models import attention as attention_mod
    from attention_lvcsr_torch.ops import attention_energy as ae
    from attention_lvcsr_torch.search.beam import DecodeConstraint
    net = dict(FLAGSHIP_NET, dec_transition="LSTM")
    U, frames, K = 16, 800, 10
    with first_call(attention_mod, "beam_attention_energies") as calls:
        decode, rec = variant_decode(
            t, dev, "28b", "lstm", net, U, frames,
            ("gru_scan", "beam_attention_energies"),
            ("beam_search_loop", "beam_search_loop_ws",
             "fused_decode_score"), rates, 283)
    L, M = calls[0][0][0].shape[1:]
    energy = kernel_at("beam_attention_energies", ae.beam_attention_energies,
                       ae.beam_attention_energies_reference, calls,
                       6 * U * K * L * M, repeats=20)
    results.setdefault("beam_attention_energies", {})[
        "lstm_decoder_U16"] = energy
    log(f"phase 28b beam_attention_energies at the LSTM decode's U={U} "
        f"K={K} L={L} M={M}: kernel {energy['ms']:.4f} ms (host-paced "
        f"eager launches), plain {energy['plain_ms']:.4f} ms, bound "
        f"{energy['bound_ms']:.5f} ms, max abs err "
        f"{energy['max_abs_err']:.2e}")
    wrng = np.random.RandomState(9)
    words = sorted({"".join(wrng.choice(CHARS[:26], size=wrng.randint(2, 8)))
                    for _ in range(300)})
    constraint = DecodeConstraint.from_words(words, CHAR_MAP, 32)
    fused = variant_decode(
        t, dev, "28b", "lstm_fused", dict(net, use_pallas="fused"), U,
        frames, ("gru_scan", "fused_decode_score"),
        ("beam_search_loop", "beam_search_loop_ws",
         "beam_attention_energies"), rates, 284, char_discount=1.0,
        validate_solution_function=constraint)[0]
    train = variant_train(t, dev, "28b", "lstm", net,
                          ("gru_scan_train_bidir", "outer_sum"),
                          ("decoder_scan_train", "gru_scan"), rates, 285)
    return {"lstm decode": decode, "lstm fused decode": fused,
            "lstm train": train}


def simple_rnn_check(t, dev, rates):
    """Phase 28c: a simple-RNN encoder and decoder at the flagship's
    widths: the module decode at U=16 (beam_attention_energies only: the
    encoder's scan and the decoder are PyTorch steps, host-paced, as the
    JAX package has them) against the plain route, one training step
    (no kernel: module scans under autograd)."""
    from __graft_entry__ import FLAGSHIP_NET
    net = dict(FLAGSHIP_NET, enc_transition="SimpleRecurrent",
               dec_transition="SimpleRecurrent")
    decode = variant_decode(
        t, dev, "28c", "simple_rnn", net, 16, 800,
        ("beam_attention_energies",),
        ("gru_scan", "beam_search_loop", "beam_search_loop_ws",
         "fused_decode_score"), rates, 286)[0]
    train = variant_train(t, dev, "28c", "simple_rnn", net, (),
                          TRAIN_KERNELS, rates, 287, n=1, n_plain=0)
    return {"simple_rnn decode": decode, "simple_rnn train": train}


class TextData(SmokeData):
    """A text-only data manager over the flagship's characters, as
    ``create_model`` and ``run_search`` read one: the inputs are the
    labels' characters (``character_map("inputs")``), no BOS."""
    add_bos = 0


def text_examples(n, seed):
    """``n`` copy-task utterances: ``inputs`` a random sentence of 20-60
    characters of words and spaces, ``labels`` the same followed by EOS
    (as the data pipeline appends it)."""
    rng = np.random.RandomState(seed)
    examples = []
    for i in range(n):
        length = rng.randint(20, 61)
        ids = rng.randint(0, 27, size=length)      # a-z and <spc>
        examples.append({
            "inputs": ids.astype(np.int64),
            "labels": np.concatenate([ids, [CHAR_MAP["<eol>"]]]).astype(
                np.int64),
            "uttids": f"text{i:02d}"})
    return examples


# the search's EOS logit raise and discount a character: the prototype's
# init (uniform, width 0.1) gives every symbol a cost of about log 32 a
# step, so without the raise no hypothesis ends within the beam (run_search
# finds none), and a discount above that cost makes the hypotheses run
# past the first EOS, so that the routes' comparison covers their symbols
AUTOENCODER_EOS_BIAS = 1.0
AUTOENCODER_CHAR_DISCOUNT = 4.0


def autoencoder_config(directory):
    """The config of phase 28d, read as ``run.py train`` reads it: a file
    in ``directory`` whose ``parent:`` names the JAX package's
    ``prototype_autoencoder.yaml`` (the port's loader resolves it to the
    port's copy), with four batches.  ``run.py`` itself reads its data
    from an H5 file through h5py, which the card's Python lacks, so the
    phase hands the config's stage in-memory batches."""
    from attention_lvcsr_torch.config import Configuration
    path = os.path.join(directory, "autoencoder.yaml")
    with open(path, "w") as f:
        f.write("parent: $LVSR_TPU/attention_lvcsr_tpu/config/prototypes/"
                "prototype_autoencoder.yaml\n"
                "training:\n    num_batches: 4\n")
    return Configuration(path)


def autoencoder_run(dev, config, out_dir, batches, valid, examples, plain):
    """``config`` (``autoencoder_config``) through ``run_stage`` (run.py
    train's driver) for its four batches, validating (and searching, as
    the prototype's monitoring does) before the first, then ``run_search``
    (run.py search's driver) over ``examples`` from the kernel route's
    checkpoint, its EOS logit raised (``AUTOENCODER_EOS_BIAS``); with
    ``plain`` every kernel swapped for its plain version.
    Returns (loop, report, stats, launches of the training, of the
    search)."""
    import io

    import torch
    from attention_lvcsr_torch.models import cells as cells_mod
    from attention_lvcsr_torch.models import generator as generator_mod
    from attention_lvcsr_torch.ops import decoder_train as dt
    from attention_lvcsr_torch.ops import gru_train as gt
    from attention_lvcsr_torch.train.driver import (create_model, run_search,
                                                    run_stage)
    def make_stage(conf, load_path):
        return dict(recognizer=create_model(conf, TextData(), load_path,
                                            device=dev),
                    batch_stream=lambda: iter(batches),
                    valid_stream=lambda: iter(valid), search_data=TextData())

    swaps = plain_decode_swaps() + [
        (cells_mod, "gru_scan_train", gt.gru_scan_train_reference),
        (generator_mod, "decoder_scan_train",
         dt.decoder_scan_train_reference)] if plain else []
    counters = variant_counters()
    with swapped(swaps):
        for c in counters.values():
            c.reset()
        loop = run_stage(config, os.path.join(out_dir, "model.zip"),
                         make_stage, printing=False)
        torch.cuda.synchronize()
        trained = counts(counters)
        rec = create_model(config, TextData(),
                           os.path.join(os.path.dirname(out_dir), "kernel",
                                        "model.zip"), device=dev)
        rec.net.generator.readout.merge_bias.data[rec.eos_label] += \
            AUTOENCODER_EOS_BIAS
        for c in counters.values():
            c.reset()
        buf = io.StringIO()
        stats = run_search(rec, [dict(ex) for ex in examples], TextData(),
                           dict(config["monitoring"]["search"],
                                char_discount=AUTOENCODER_CHAR_DISCOUNT),
                           print_to=buf)
        torch.cuda.synchronize()
        searched = counts(counters)
    return loop, buf.getvalue(), stats, trained, searched


def autoencoder_check(t, dev, results, rates):
    """Phase 28d: prototype_autoencoder.yaml (lookup bottom, content
    attention, the states in the readout, no post-merge layer) on a
    seeded copy task: four batches of ten and a search over 16
    utterances, on the kernel route and on the plain route; the training
    kernels and the encoder's scan timed at the prototype's shapes."""
    from attention_lvcsr_torch.data.pipeline import pad_batch
    from attention_lvcsr_torch.models import cells as cells_mod
    from attention_lvcsr_torch.models import generator as generator_mod
    from attention_lvcsr_torch.ops import decoder_train as dt
    from attention_lvcsr_torch.ops import gru_scan as gs
    from attention_lvcsr_torch.ops import gru_train as gt
    pad = lambda exs: pad_batch(exs, ["inputs", "labels"])
    train = text_examples(40, 288)
    batches = [pad(train[i:i + 10]) for i in range(0, 40, 10)]
    valid = [pad(text_examples(10, 289))]
    examples = text_examples(16, 290)
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "kernel"))
        os.makedirs(os.path.join(tmp, "plain"))
        config = autoencoder_config(tmp)
        with first_call(cells_mod, "gru_scan_train") as train_calls, \
                first_call(generator_mod, "decoder_scan_train") as dec_calls, \
                first_call(cells_mod, "gru_scan") as scan_calls:
            t0 = time.perf_counter()
            loop, report, stats, trained, searched = autoencoder_run(
                dev, config, os.path.join(tmp, "kernel"), batches, valid,
                examples, False)
            seconds = time.perf_counter() - t0
        ploop, preport, pstats, ptrained, psearched = autoencoder_run(
            dev, config, os.path.join(tmp, "plain"), batches, valid,
            examples, True)
    if min(trained["gru_scan_train_bidir"], trained["decoder_scan_train"],
           trained["outer_sum"], searched["gru_scan"]) < 1 \
            or searched["beam_search_loop"] or searched["beam_search_loop_ws"]:
        fail(f"autoencoder: the kernel route did not take its kernels: "
             f"training {trained}, search {searched}")
    if any(ptrained[k] for k in TRAIN_KERNELS) or any(psearched.values()):
        fail(f"autoencoder: the plain route launched kernels: {ptrained}, "
             f"{psearched}")
    got, ref = (np.array(x.log.channel("train_cost")[1]) for x in (loop,
                                                                   ploop))
    rel = np.abs(got - ref) / np.abs(ref)
    if not (len(got) == len(ref) == 4 and np.isfinite(got).all()
            and rel.max() <= 1e-4):
        fail(f"autoencoder: train_cost per batch {got} vs plain {ref}")
    err = reports_agree("autoencoder search", report, preport,
                        list(range(len(examples))), stats, pstats)
    recognized = [u.get("Recognized", "") for u in parse_report(report)]
    if sum(1 for r in recognized if r) < len(examples) // 2:
        fail(f"autoencoder search: fewer than half the hypotheses are "
             f"non-empty ({recognized}): the comparison is too weak")
    rates["autoencoder_train_and_search_s"] = seconds
    shapes = {}
    for key, kernel, plain, calls in (
            ("gru_scan_train_bidir", gt.gru_scan_train,
             gt.gru_scan_train_reference, train_calls),
            ("decoder_scan_train", dt.decoder_scan_train,
             dt.decoder_scan_train_reference, dec_calls),
            ("gru_scan", gs.gru_scan, gs.gru_scan_reference, scan_calls)):
        proj = calls[0][0][0]
        T, B = proj.shape[:2]
        if key == "decoder_scan_train":
            S = calls[0][0][13].shape[0]
            L, M = calls[0][0][3].shape[1:]
            D = calls[0][0][4].shape[2]
            # the fork of the fed-back labels comes in precomputed (fx,
            # fg): phase 20a's count of the content branch
            ops = T * B * (attention_step_ops(S, M, L, 0, D)
                           + 2 * D * 3 * S + gru_step_ops(S))
            dims = dict(T=T, B=B, L=L, M=M, D=D, S=S)
        else:
            D = calls[0][0][2][1].shape[0]
            ops = T * B * (2 if len(calls[0][0]) > 3 else 1) \
                * gru_step_ops(D)
            dims = dict(T=T, B=B, D=D)
        shapes[key] = dict(kernel_at(key, kernel, plain, calls, ops),
                           dims=dims)
        results.setdefault(key, {})["autoencoder"] = shapes[key]
        log(f"phase 28d {key} at the autoencoder's {dims}"
            f" (forward): kernel {shapes[key]['ms']:.3f} ms, plain "
            f"{shapes[key]['plain_ms']:.3f} ms, bound "
            f"{shapes[key]['bound_ms']:.5f} ms, max abs err "
            f"{shapes[key]['max_abs_err']:.2e}")
    log(f"phase 28d autoencoder: train_cost per batch {got.tolist()} vs "
        f"plain {ref.tolist()} (max rel err {rel.max():.2e}); launches in "
        f"training {trained}, in the search {searched}; search over "
        f"{len(examples)} utterances agrees with the plain route (max rel "
        f"cost err {err:.2e}), {sum(1 for r in recognized if r)} "
        f"non-empty hypotheses, CER {stats['total_errors'] / stats['total_length']:.3f}; "
        f"kernel route {seconds:.1f} s for the four batches and the search")
    return {"autoencoder train": trained, "autoencoder search": searched}


def variants_phase(t, dev, results, rates):
    """Phase 28: the model variants no recipe uses, each on the kernels
    its route takes.  Returns the kernel routes' launches per part."""
    moved = {}
    marks = [time.perf_counter()]
    for check in (top_onehot_check, lstm_decoder_check):
        moved.update(check(t, dev, results, rates))
        marks.append(time.perf_counter())
    moved.update(simple_rnn_check(t, dev, rates))
    marks.append(time.perf_counter())
    moved.update(autoencoder_check(t, dev, results, rates))
    marks.append(time.perf_counter())
    parts = "abcd"
    log("phase 28: " + ", ".join(
        f"{p} {b - a:.1f} s" for p, a, b in zip(parts, marks, marks[1:]))
        + f", all {marks[-1] - marks[0]:.1f} s")
    return moved



# Phase 29: the quality proxy's fast tier (attention_lvcsr_torch/cli/
# quality_proxy.py) from seed 7, its data in memory (the card's Python has
# no h5py).  QUALITY_EPOCHS (pretraining, main) are the fewest with which
# the trained model's decodes are mostly non-empty; the tier's default
# (1, 2) leaves the no-LM decodes at WER 1.0.
QUALITY_SEED = 7
QUALITY_EPOCHS = "2,8"
QUALITY_SEARCH = {"stop_on": "patience", "round_to_inf": 1e9}
# (condition, beam, char_discount, utterances): the tool's four decodes
# of the 50 test utterances at exp/wsj/decode.sh's discounts (0.1 without
# the LM, 1.0 with it), beam 10 and the tier's wide beam 20, and the no-LM
# decode at the other tiers' beam 200 of one batch of 16, which at the
# fast tier's widths passes a block (the loop kernel's workspace instance)
QUALITY_DECODES = (("nolm", 10, 0.1, None), ("lm", 10, 1.0, None),
                   ("nolm", 20, 0.1, None), ("lm", 20, 1.0, None),
                   ("nolm", 200, 0.1, 16))


def utterance_rows(out, n):
    """The first ``n`` utterances of a decode's outputs (the rest of the
    batch is padding)."""
    return {k: (v[:n] if np.ndim(v) else v) for k, v in out.items()}


def quality_phase(dev, rates):
    """Phase 29: the quality proxy's fast tier trained and decoded on the
    kernels, each stage's first step and every decode held against the
    plain route.  Returns the kernel route's launches."""
    import torch
    from attention_lvcsr_torch.cli import quality_proxy as qp
    from attention_lvcsr_torch.data import Data
    from attention_lvcsr_torch.models import cells as cells_mod
    from attention_lvcsr_torch.models import generator as generator_mod
    from attention_lvcsr_torch.ops import decoder_train as dt
    from attention_lvcsr_torch.ops import gru_train as gt
    from attention_lvcsr_torch.train import driver
    plain_train = [(cells_mod, "gru_scan_train", gt.gru_scan_train_reference),
                   (generator_mod, "decoder_scan_train",
                    dt.decoder_scan_train_reference)]
    counters = qp.launch_counters()
    marks = [time.perf_counter()]
    tmp = tempfile.mkdtemp()
    try:
        built = qp.build(tmp, QUALITY_SEED, "fast", QUALITY_EPOCHS,
                         in_memory=True)
        marks.append(time.perf_counter())
        save_dir = os.path.join(tmp, "kernels")
        for c in counters.values():
            c.reset()
        meta, loops = qp.train(built, save_dir, dev)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        data = Data(**built["config"]["data"])
        ckpt = os.path.join(save_dir, "main.zip")
        models = {"nolm": driver.create_model(built["config"], data, ckpt,
                                              device=dev),
                  "lm": qp.lm_model(built, data, ckpt, dev)}
        rows, outputs = {}, {}
        for cond, beam, cd, limit in QUALITY_DECODES:
            outputs[cond, beam] = []
            rows[cond, beam] = qp.decode_and_score(
                models[cond], data, beam,
                dict(QUALITY_SEARCH, char_discount=cd), limit=limit,
                outputs=outputs[cond, beam])
        torch.cuda.synchronize()
        moved = counts(counters)
        marks.append(time.perf_counter())

        # the plain route: each stage's first step from the kernel route's
        # start (the seed's initialization, then pretraining_best_ll.zip)
        starts = (None, os.path.join(save_dir, "pretraining_best_ll.zip"))
        for c in counters.values():
            c.reset()
        with swapped(plain_train):
            for (name, stage), start, loop in zip(
                    built["config"].ordered_stages.items(), starts, loops):
                stage = copy.deepcopy(stage)
                stage["training"]["num_batches"] = 1
                ref, = driver.run_multistage(
                    [(name, stage)], os.path.join(tmp, "plain"),
                    driver.data_stage(dev), start, fast_start=True,
                    printing=False)
                agree = []
                for key in ("train_cost", "total_gradient_norm"):
                    (tg, g), (tr, r) = (loop.log.channel(key),
                                        ref.log.channel(key))
                    rel = abs(g[0] - r[0]) / abs(r[0])
                    if tg[:1] != tr or not (np.isfinite(g).all()
                                            and rel <= 1e-4):
                        fail(f"phase 29 {name}: the first step's {key} "
                             f"{g[:1]} vs the plain route's {r}")
                    agree.append(f"{key} {g[0]:.6f} vs {r[0]:.6f}")
                log(f"phase 29 {name}: {loop.log.status['iterations_done']}"
                    f" steps on the kernels; the first step's "
                    + ", ".join(agree) + " on the plain route")
        # every decode on the plain route
        with swapped(plain_decode_swaps()):
            for cond, beam, cd, limit in QUALITY_DECODES:
                ref_outputs = []
                ref = qp.decode_and_score(
                    models[cond], data, beam,
                    dict(QUALITY_SEARCH, char_discount=cd), limit=limit,
                    outputs=ref_outputs)
                got = rows[cond, beam]
                nonempty = 0
                for (n, out), (_, ref_out) in zip(outputs[cond, beam],
                                                  ref_outputs):
                    got_rows = utterance_rows(out, n)
                    compare_outputs(f"phase 29 {cond} beam {beam}", got_rows,
                                    utterance_rows(ref_out, n),
                                    reorder=True)
                    nonempty += int(got_rows["done_valid"].any(axis=1).sum())
                if len(ref_outputs) != len(outputs[cond, beam]) or any(
                        got[k] != ref[k] for k in ("cer", "wer", "empty")):
                    fail(f"phase 29 {cond} beam {beam}: {got} vs the plain "
                         f"route's {ref}")
                if nonempty <= got["utterances"] // 2:
                    fail(f"phase 29 {cond} beam {beam}: {nonempty} of "
                         f"{got['utterances']} hypotheses non-empty: the "
                         f"comparison is too weak")
                rates[f"quality_{cond}_beam{beam}_utt_per_s"] = \
                    got["utt_per_s"]
                rates[f"plain_quality_{cond}_beam{beam}_utt_per_s"] = \
                    ref["utt_per_s"]
                log(f"phase 29 {cond} beam {beam} char_discount {cd}: CER "
                    f"{got['cer']} WER {got['wer']} on both routes, "
                    f"{nonempty} of {got['utterances']} non-empty; "
                    f"{got['utt_per_s']} utt/s, plain {ref['utt_per_s']}; "
                    f"launches {got['launches']}")
        if any(counts(counters).values()):
            fail(f"phase 29: the plain route launched kernels: "
                 f"{counts(counters)}")
        marks.append(time.perf_counter())
    finally:
        shutil.rmtree(tmp)
    if min(moved.values()) < 1:
        fail(f"phase 29: a kernel of the path did not launch: {moved}")
    rates["quality_train_s"] = meta["train_wall_s"]
    log(f"phase 29: LG_pushed {built['graph']['LG_pushed'].num_states} "
        f"states in {built['graph_s']:.2f} s; epochs {QUALITY_EPOCHS}, "
        f"training {meta['train_wall_s']} s, launches {moved}; "
        + ", ".join(f"{p} {b - a:.1f} s" for p, a, b in zip(
            ("build", "train", "decodes", "plain"), marks, marks[1:]))
        + f", all {marks[-1] - marks[0]:.1f} s")
    return moved


if __name__ == "__main__":
    main()
