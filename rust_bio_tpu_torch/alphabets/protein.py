"""Protein alphabets (own copy of ``rust_bio_tpu.alphabets.protein``;
reference: src/alphabets/protein.rs)."""

from rust_bio_tpu_torch.alphabets.core import Alphabet


def alphabet() -> Alphabet:
    """The 20 common amino acids, upper+lowercase. protein.rs:20"""
    return Alphabet(b"ARNDCEQGHILKMFPSTWYVarndceqghilkmfpstwyv")


def iupac_alphabet() -> Alphabet:
    """The IUPAC amino acid alphabet. protein.rs:26"""
    return Alphabet(b"ABCDEFGHIKLMNPQRSTVWXYZabcdefghiklmnpqrstvwxyz")
