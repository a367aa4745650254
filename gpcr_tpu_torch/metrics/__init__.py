from .psnr import psnr, psnr255
from .ssim import ssim, ms_ssim
from .lpips import LPIPS, lpips_available
