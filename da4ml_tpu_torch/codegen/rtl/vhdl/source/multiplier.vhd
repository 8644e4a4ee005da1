-- o = a * b (DAIS opcode 7), low WO bits of the full product.
library ieee;
use ieee.std_logic_1164.all;
use ieee.numeric_std.all;
use work.da4ml_util.all;

entity multiplier is
    generic (WA : integer := 8; SA : integer := 1; WB : integer := 8; SB : integer := 1; WO : integer := 16);
    port (
        a : in std_logic_vector(WA - 1 downto 0);
        b : in std_logic_vector(WB - 1 downto 0);
        o : out std_logic_vector(WO - 1 downto 0)
    );
end entity;

architecture rtl of multiplier is
    constant WI : integer := WA + WB + 2;
    signal ea, eb : signed(WI - 1 downto 0);
    signal prod : signed(2 * WI - 1 downto 0);
begin
    ea <= ext(a, SA, WI);
    eb <= ext(b, SB, WI);
    prod <= ea * eb;
    o <= std_logic_vector(prod(WO - 1 downto 0));
end architecture;
