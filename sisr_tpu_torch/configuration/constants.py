"""Directory layout and hard-coded dataset splits (copy of sisr_tpu's constants).

Mirrors the reference constants (ref: Code/SISR/configuration/constants.py:1-19):
``Results/ Data/ Scratch/`` directories are siblings of the package base directory and
the celeba/div2k/flickr2k train/eval/test splits are fixed index ranges.
"""
import os

base_directory = os.path.abspath(os.path.join(__file__, os.path.pardir, os.path.pardir))
results_directory = os.path.join(os.path.dirname(os.path.dirname(base_directory)), 'Results')

# Dataset splits (ref: constants.py:9-14)
data_splits = {'celeba': {'train': (0, 162770),
                          'eval': (162770, 182637),
                          'test': (182637, 202599)},
               'div2k': {'train': (0, 800),
                         'eval': (800, 900)},
               'flickr2k': {'train': (0, 2650)}}
