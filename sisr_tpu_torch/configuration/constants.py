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

# The 40 attribute columns of CelebA's list_attr_celeba.txt, in its order (the file a
# data table's ``attributes`` and eval_sisr's --data_attributes name)
celeba_attributes = (
    '5_o_Clock_Shadow', 'Arched_Eyebrows', 'Attractive', 'Bags_Under_Eyes', 'Bald', 'Bangs',
    'Big_Lips', 'Big_Nose', 'Black_Hair', 'Blond_Hair', 'Blurry', 'Brown_Hair',
    'Bushy_Eyebrows', 'Chubby', 'Double_Chin', 'Eyeglasses', 'Goatee', 'Gray_Hair',
    'Heavy_Makeup', 'High_Cheekbones', 'Male', 'Mouth_Slightly_Open', 'Mustache',
    'Narrow_Eyes', 'No_Beard', 'Oval_Face', 'Pale_Skin', 'Pointy_Nose', 'Receding_Hairline',
    'Rosy_Cheeks', 'Sideburns', 'Smiling', 'Straight_Hair', 'Wavy_Hair', 'Wearing_Earrings',
    'Wearing_Hat', 'Wearing_Lipstick', 'Wearing_Necklace', 'Wearing_Necktie', 'Young')
