# Copy of metaeuk_tpu/pipeline/sequence2profile.py; it differs from its original only in this note.
"""sequence2profile: context-specific profile from a single sequence
(lib/mmseqs/src/util/sequence2profile.cpp).

Each sequence is scored against a CRF context library, the mixed
pseudocount distribution is admixed with the one-hot sequence at rate
(1 - tau), log-PSSM bytes are derived, tantan-masked columns are
overwritten with -1 (Masker::maskPssm, commons/Masker.cpp:57-80), and
the result is serialized as a 25-byte-per-position HMM profile DB
(PSSMCalculator::Profile::toBuffer, alignment/PSSMCalculator.cpp:671).

Replicated quirks: computeLogPSSM reads the stride-24 CS profile buffer
with stride 20 (sequence2profile.cpp:61 + PSSMCalculator.cpp:259-272),
so pssm bytes past position 0 mix neighbouring rows/padding; and the
consensus byte is aa2num[numeric residue], which collapses to 20 ('X')
for every position because numeric residues are control characters
(sequence2profile.cpp:62-70 passing seq.numSequence as consensus).

The reference bakes its CRF model (K4000.crf) into the binary; that
blob is missing upstream (LFS), so the library file is a required
argument here (tests use the synthetic tests/data/tiny.crf baked into
the parity-reference rebuild).
"""

import numpy as np

from ..data.submat import encode_aa, BLOSUM62_PBACK
from ..io import mmseqsdb
from ..ops.csprofile import (ContextLibrary, compute_sequence_cs,
                             compute_log_pssm_from_cs)
from ..ops.masker import repeat_probs
from ..ops.pssm import convert_neff_to_char


def sequence2profile(in_db, out_db, context_lib, tau=0.9,
                     mask_profile=True, mask_prob=0.9):
    lib = (context_lib if isinstance(context_lib, ContextLibrary)
           else ContextLibrary.from_file(context_lib))
    neff1_byte = convert_neff_to_char(np.float32(1.0))
    out = []
    for key, payload in mmseqsdb.read_seq_entries(in_db):
        enc = encode_aa(payload)
        L = len(enc)
        profile24 = compute_sequence_cs(lib, enc, tau)
        pssm = compute_log_pssm_from_cs(profile24, BLOSUM62_PBACK[:20])
        if mask_profile:
            masked = repeat_probs(enc) >= np.float32(mask_prob)
            pssm[masked, :] = -1
        rec = np.zeros((L, 25), np.uint8)
        rec[:, :20] = pssm.view(np.uint8)
        rec[:, 20] = enc                 # query residue
        rec[:, 21] = 20                  # aa2num[control char] == 'X'
        rec[:, 22] = neff1_byte          # Neff_M filled with 1.0
        out.append((key, rec.tobytes()))
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_HMM_PROFILE)
    return out_db
